"""Image ops (``image``) and the hand-written CUDA kernels' wrappers
(``cuda_*``), built, launched and counted by ``_build``."""
