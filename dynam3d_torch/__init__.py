"""dynam3d_torch: the PyTorch + CUDA port of the Dynam3D VLN serving step.

Runs on an NVIDIA GPU (Hopper kernels in ``csrc/``); every entry point also
takes ``device="cpu"``, where the kernels' plain PyTorch versions run.  The
package imports neither JAX nor the reference package.
"""
