"""implicit_image_tpu_torch — the PyTorch + CUDA port of implicit_image_tpu.

The JAX package beside it is the reference; this package mirrors its module
names so each counterpart is easy to find. The ported compress -> decode
loop, for SIREN and CoordX:

    fit, dense or sparse, cold or warm from a meta-init (training/fit.py,
    training/metainit.py, sparsity/) -> k-means codebook finetune, absolute
    or delta, at one width or per layer (training/quant_phase.py,
    quant/allocate.py) -> container, flat or progressive, and stream
    backend (coding/, quant/base_layer.py) -> decode + render, at any
    lattice, window or band, one run or many (decompress.py)

Every SIREN forward and backward on a CUDA tensor runs through the
hand-written Hopper kernels in `csrc/` (ops/sine_mlp.py); on a CPU tensor
the same functions run their plain-torch versions, which the tests hold
against the JAX package. CoordX has no kernel: its products are fp32
torch.matmul, as they were XLA products in the JAX package.

The package imports torch and never jax. Importing it builds nothing: the
CUDA kernels are compiled with nvcc at their first launch, and the native
entropy codecs with g++ at theirs.
"""

__version__ = "0.1.0"
