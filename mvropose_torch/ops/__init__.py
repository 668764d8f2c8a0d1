"""Hand-written CUDA kernels for Hopper and their plain-torch versions.

Each wrapper launches its kernel for a CUDA tensor and takes the plain
version only for a CPU tensor; it counts its launches in a module-level
`launches` integer.
"""
