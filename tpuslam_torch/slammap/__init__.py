"""Map data model: keyframes, line landmarks, covisibility."""
