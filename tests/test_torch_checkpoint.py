"""The checkpoint store, on the CPU: ``repro``'s contract on the port's trees.

A training state (f32 and bf16 leaves, lists of layers, an int32 step)
round-trips bit for bit, into the template's structure and dtypes; a save
publishes atomically (no ``.tmp`` left, the file complete); ``keep`` keeps
the newest checkpoints; an async save is written by ``wait``; a failed
writer's error surfaces on ``wait``; a shape mismatch raises
``ValueError`` and a missing leaf ``KeyError`` (``tests/test_runtime.py``'s
checkpoint test, ported).
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store as store_mod
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.tree import leaves, leaves_with_paths


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"embed": {"table": torch.randn(7, 4, generator=g)},
                   "layers": [{"w": torch.randn(4, 4, generator=g).to(torch.bfloat16),
                               "scale": torch.randn(4, generator=g)} for _ in range(2)]},
        "opt": {"m": {"x": torch.randn(3, generator=g)}, "v": {"x": torch.rand(3, generator=g)}},
        "step": torch.tensor(12, dtype=torch.int32),
    }


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_round_trip_bit_for_bit(tmp_path):
    store = CheckpointStore(str(tmp_path))
    state = _state()
    store.save(12, state, {"step": 12})
    template = _state(1)  # other values, same structure
    restored, meta = store.restore(12, template)
    assert meta == {"step": 12}
    assert [p for p, _ in leaves_with_paths(restored)] == [p for p, _ in
                                                           leaves_with_paths(state)]
    for got, want in zip(leaves(restored), leaves(state)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want))
    with np.load(tmp_path / "ckpt_00000012.npz") as z:
        assert "params::layers::1::w" in z.files and z["params::layers::1::w"].dtype == np.int16
    step, latest, _ = store.restore_latest(template)
    assert step == 12 and int(latest["step"]) == 12


def test_atomicity_and_gc(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        store.save(s, _state(s), {"step": s}, blocking=True)
    assert store.latest_step() == 3
    files = sorted(os.listdir(tmp_path))
    assert files == ["ckpt_00000002.npz", "ckpt_00000003.npz"]
    restored, meta = store.restore(3, _state())
    assert meta["step"] == 3
    torch.testing.assert_close(restored["params"]["embed"]["table"],
                               _state(3)["params"]["embed"]["table"], rtol=0, atol=0)


def test_async_save_and_wait(tmp_path):
    store = CheckpointStore(str(tmp_path))
    state = _state()
    store.save(5, state, {"step": 5}, blocking=False)
    store.wait()
    assert store.latest_step() == 5
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    restored, _ = store.restore(5, state)
    assert torch.equal(_bits(restored["params"]["layers"][0]["w"]),
                       _bits(state["params"]["layers"][0]["w"]))


def test_writer_error_surfaces_on_wait(tmp_path, monkeypatch):
    store = CheckpointStore(str(tmp_path))

    def failing_savez(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(store_mod.np, "savez", failing_savez)
    store.save(1, _state(), blocking=False)
    with pytest.raises(OSError, match="disk full"):
        store.wait()
    store.wait()  # the error is raised once
    assert store.latest_step() is None  # nothing published


def test_the_snapshot_is_a_copy_of_its_own():
    """``save``'s host snapshot shares no memory with a CPU state, so a
    step that updates the state in place while an async write runs cannot
    reach the checkpoint."""
    state = _state()
    flat = store_mod._flatten(state)
    for path, leaf in leaves_with_paths(state):
        assert not np.shares_memory(flat["::".join(path)], _bits(leaf).numpy()), path
    before = {k: v.copy() for k, v in flat.items()}
    for leaf in leaves(state):
        leaf.add_(1)
    assert all(np.array_equal(flat[k], before[k]) for k in flat)


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(1, _state())
    wrong = _state()
    wrong["params"]["embed"]["table"] = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        store.restore(1, wrong)
    extra = _state()
    extra["opt"]["m"]["y"] = torch.zeros(1)
    with pytest.raises(KeyError, match="opt::m::y"):
        store.restore(1, extra)
