"""tpuslam_torch — stereo and monocular line SLAM in PyTorch, with hand-written CUDA kernels.

The PyTorch/CUDA counterpart of the JAX package ``tpuslam``. Modules keep
the JAX package's layout and names (``geometry/``, ``kernels/``,
``frontend/``, ``backend/``, ``slammap/``, ``io/``, ``eval/``,
``system.py``), so each has an obvious counterpart. The three Pallas
kernels of ``tpuslam`` (blur, gradients, connected-component propagation)
are CUDA C++ kernels under ``csrc/``, built at first use on a CUDA tensor;
on a CPU tensor every kernel wrapper runs its plain PyTorch version.

Implemented so far: stereo and monocular line SLAM, lines only or with
hybrid points. ``System(cam)`` with its defaults (``sensor="stereo",
mapping=True, loop_closing=True``): synchronous or pipelined tracking with
relocalization, local mapping with an LM+Schur local bundle adjustment at
every keyframe, and loop closing (SE(3) essential graph, landmark
correction, global bundle adjustment), on the card with local and global
BA in a persistent solver process (``backend/ba_worker.py``; local BA
asynchronous, as the JAX package runs it on its chip).
``System(cam, sensor="mono")``:
a two-view bootstrap, synchronous tracking, two-view triangulation of new
lines and points in the mapper, and loop closing on the Sim(3) branch.
``parallel/``: N stereo sequences tracked concurrently (``MultiTracker``,
one set of kernel launches per stage for all N) and batched local BA
(``batched_ba``), BASELINE config #5. The host surface: settings files
(``io/config.py``, ``System(settings)``), map files in the JAX package's
format (``System.save_map`` / ``load_map``), dataset readers
(``io/datasets.py``), RPE, ``viz.py`` and the command line
(``python -m tpuslam_torch.cli``).
"""

__version__ = "0.1.0"

import torch as _torch

# The pose LM loses tracking when its normal equations are formed at reduced
# precision (the JAX package pins f32 matmuls for the same reason). On the
# card, float32 convolutions default to TF32 through cuDNN: pin full f32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from tpuslam_torch.geometry.camera import Intrinsics  # noqa: E402


def __getattr__(name):
    """Lazy top-level exports (keep ``import tpuslam_torch`` light)."""
    if name == "System":
        from tpuslam_torch.system import System

        return System
    if name == "SlamMap":
        from tpuslam_torch.slammap.map import SlamMap

        return SlamMap
    raise AttributeError(name)


__all__ = ["Intrinsics", "System", "SlamMap", "__version__"]
