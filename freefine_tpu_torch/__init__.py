"""FreeFine in PyTorch for NVIDIA Hopper: the port of `freefine_tpu`.

The geometric-edit pipeline (`pipeline.FreeFine.generation`) with its
models, scheduler, masks and attention ops; the two attention kernels of
its path (`ops.flash_attention`) are hand-written CUDA for sm_90a.  The
package imports torch and numpy, never JAX or `freefine_tpu`.
"""
