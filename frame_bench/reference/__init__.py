"""The benchmark's plain reference renderer.

A frozen copy of the port's eager frame path (scene, packing, glTF and
PNG loading, frame state, transforms, lighting, atmosphere LUTs, sky
pass, OETF) in plain PyTorch and NumPy, with a plain block raster in
place of the port's CUDA kernel. It imports nothing of the port or of the
JAX package; the benchmark hands it the same scene inputs it hands the
port, and it parses and packs them again itself.
"""
