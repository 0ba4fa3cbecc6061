"""PyTorch + CUDA port of the SIVF reproduction, for NVIDIA Hopper.

Module paths mirror ``repro`` one to one; each module names the reference
it is held against. The port imports nothing of the JAX package.
"""
