"""The data pipeline against the JAX package's, on the CPU.

``synthetic_batches`` equals ``repro``'s byte for byte (keys, dtypes,
shapes, bytes) for the dense, VLM and encoder-decoder families, from step 0
and resumed at a later step; ``PrefetchingLoader`` on the CPU yields the
batches in order as tensors and shuts down (``tests/test_runtime.py``'s
loader test), and surfaces an error of its iterator in the consumer.
"""

import itertools

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.data.pipeline import synthetic_batches as jax_batches

from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import PrefetchingLoader, synthetic_batches


@pytest.mark.parametrize("start", [0, 5])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "paligemma-3b", "seamless-m4t-large-v2"])
def test_synthetic_batches_equal_jax_byte_for_byte(arch, start):
    cfg, jcfg = reduced(ARCHS[arch]), jax_reduced(JAX_ARCHS[arch])
    shape, jshape = ShapeSpec("t", 24, 3, "train"), JaxShapeSpec("t", 24, 3, "train")
    got = list(itertools.islice(synthetic_batches(cfg, shape, seed=7, start_step=start), 3))
    want = list(itertools.islice(jax_batches(jcfg, jshape, seed=7, start_step=start), 3))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape
            assert g[key].tobytes() == w[key].tobytes()
    assert ("patches" in want[0]) == (cfg.family == "vlm")
    assert ("frames" in want[0]) == (cfg.family == "audio_encdec")


def test_prefetching_loader_order_and_shutdown():
    cfg = reduced(ARCHS["qwen3-0.6b"])
    shape = ShapeSpec("t", seq_len=16, global_batch=2, kind="train")
    loader = PrefetchingLoader(synthetic_batches(cfg, shape, seed=3))
    b0, b1 = next(loader), next(loader)
    want = list(itertools.islice(synthetic_batches(cfg, shape, seed=3), 2))
    for got, w in zip((b0, b1), want):
        assert isinstance(got["tokens"], torch.Tensor) and got["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(got["tokens"].numpy(), w["tokens"])
    assert b0["tokens"].shape == (2, 16)
    assert not torch.equal(b0["tokens"], b1["tokens"])
    loader.close()
    loader._thread.join(timeout=5)
    assert not loader._thread.is_alive()


def test_prefetching_loader_surfaces_an_iterator_error():
    def broken():
        yield {"tokens": np.zeros((1, 2), np.int32)}
        raise ValueError("bad shard")

    loader = PrefetchingLoader(broken())
    assert next(loader)["tokens"].shape == (1, 2)
    with pytest.raises(ValueError, match="bad shard"):
        next(loader)
