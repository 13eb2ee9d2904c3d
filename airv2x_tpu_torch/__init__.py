"""airv2x_tpu_torch — the PyTorch/CUDA port of ``airv2x_tpu`` for NVIDIA Hopper.

Slice 1 covers the flagship Where2comm LiDAR detection path in eval mode:
points -> hetero pillar encoder -> BEV backbone -> confidence-gated
multi-scale fusion -> heads -> top-k decode -> rotated NMS.

The two TPU kernels on that path are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use (``kernels.py``). Each kernel's
wrapper launches it for a CUDA tensor and runs its plain PyTorch version
(same module) for a CPU tensor.

The package imports ``torch``, ``numpy`` and ``yaml`` only: nothing of JAX and
nothing of ``airv2x_tpu``. Module docstrings name their JAX counterparts.
"""

__version__ = "0.1.0"
