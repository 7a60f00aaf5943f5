"""implicit_image_tpu_torch — the PyTorch + CUDA port of implicit_image_tpu.

The JAX package beside it is the reference; this package mirrors its module
names so each counterpart is easy to find. The ported compress -> decode
loop, for every model family of the JAX registry:

    fit, dense or sparse, cold or warm from a meta-init (training/fit.py,
    training/metainit.py, sparsity/) -> k-means codebook finetune, absolute
    or delta, at one width or per layer (training/quant_phase.py,
    quant/allocate.py) -> container, flat or progressive, and stream
    backend (coding/, quant/base_layer.py) -> decode + render, at any
    lattice, window or band, one run or many (decompress.py)

Every SIREN forward and backward on a CUDA tensor runs through the
hand-written Hopper kernels in `csrc/` (ops/sine_mlp.py); on a CPU tensor
the same functions run their plain-torch versions, which the tests hold
against the JAX package. The other families' own products (CoordX,
Fourier, hashgrid, the DWT) are fp32 torch ops, as they were XLA products
in the JAX package.

Beside the compress and decode CLIs: many images fitted together over a
member axis (parallel/, fleet.py), the density search to a byte or dB
target (target.py), the hyper-parameter sweeper (sweep.py), REPTILE
meta-training of the warm-start artifacts (meta_train.py,
training/metainit.py), sequence (video) coding with inter-frame `prev`
containers and .iiv files (sequence.py, coding/container_file.py), and
the Python API below (api.py).

    import implicit_image_tpu_torch as iit
    result = iit.compress_image(img, overrides=["entropy_coding=auto"])
    decoded = result.decode()

The package imports torch and never jax. Importing it builds nothing: the
CUDA kernels are compiled with nvcc at their first launch, and the native
entropy codecs with g++ at theirs; the API loads on first use.
"""

__version__ = "0.1.0"

__all__ = ["compress_image", "compress_images", "decompress_image", "CompressedImage"]


def __getattr__(name):
    # lazy: importing the package stays cheap (the CLIs import it before
    # parsing their arguments); the API pulls in the orchestrator
    if name in __all__:
        from implicit_image_tpu_torch import api

        return getattr(api, name)
    raise AttributeError(name)
