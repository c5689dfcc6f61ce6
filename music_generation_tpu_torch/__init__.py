"""music_generation_tpu_torch — the PyTorch/CUDA port of music_generation_tpu.

Same system (G2P frontend, melody transformer, VISinger SVS, HTTP serving)
in idiomatic PyTorch for one NVIDIA H100; the JAX package beside it stays
the reference. Hand-written Hopper kernels live in ``csrc/`` and build on
first use into ``build/music_generation_tpu_torch/``.
"""

__version__ = "0.1.0"
