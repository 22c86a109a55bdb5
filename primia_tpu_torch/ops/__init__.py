"""Image ops (``image``) and the hand-written CUDA kernels' wrappers
(``cuda_clahe``), built by ``_build``."""
