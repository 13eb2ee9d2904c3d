"""airv2x_tpu_torch — the PyTorch/CUDA port of ``airv2x_tpu`` for NVIDIA Hopper.

It covers the flagship Where2comm LiDAR model, for detection (points ->
hetero pillar encoder -> BEV backbone -> confidence-gated multi-scale fusion
-> heads -> top-k decode -> rotated NMS) and for BEV segmentation (the same
trunk -> seg head -> class maps), in eval mode and in training (synthetic
anchor-labelled batches, the two losses, AdamW, checkpoints, the train CLI
``python -m airv2x_tpu_torch.tools.train``).

Every TPU kernel of the JAX package has a hand-written CUDA C++ counterpart
for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use
(``kernels.py``). Each kernel's wrapper launches it for a CUDA tensor and
runs its plain PyTorch version (same module) for a CPU tensor.

It reads the AirV2X dataset from disk (``data/``), trains on it, and scores a
model with the evaluation CLIs (``tools/inference*.py``: AP, multiclass mAP,
BEV mIoU; ``tools/chip_ap_gate.py`` holds the card's AP table to the CPU's).

The package imports ``torch``, ``numpy`` and ``yaml`` (and ``PIL`` inside the
seg-label reader) only: nothing of JAX and nothing of ``airv2x_tpu``. Module
docstrings name their JAX counterparts.
"""

__version__ = "0.1.0"
