"""Tracking front end: feature extraction, map matching, the Tracker (torch)."""
