"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Nothing here builds or imports a compiler when the package is imported:
``_build`` runs ``nvcc`` the first time a kernel is launched.
"""
