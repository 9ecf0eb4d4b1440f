"""Training MLA with MoE (deepseek-v2-lite-16b, reduced) against the JAX
package's, on the CPU.

The reduced config keeps deepseek-v2-lite's attention widths (q/k 128 +
64 = 192 and v 128), so ``mla_forward`` under grad goes through
``FlashAttentionFn`` at the pair (192, 128), the widths whose tensor-core
backward (``dq_tc`` + ``dkdv_wg``) trains it on the card; here its plain
version.  Its first block is dense (``first_k_dense`` 1: kind ``"mla"``),
the next ``"mla_moe"`` with a shared expert.  The checks are
``test_torch_moe_train.py``'s, routing asserted equal first:

1. each block's (``"mla"`` and ``"mla_moe"``) parameter and input
   gradients with f32 activations against ``jax.grad`` of ``repro``'s
   ``block_forward`` (``BLOCK_TOL``);
2. the whole model's loss, aux and per-leaf gradients with bf16
   activations under full remat against ``jax.value_and_grad`` of
   ``repro``'s ``loss_fn`` (``LOSS_TOL``, ``MODEL_TOL``), also at a
   ``capacity_factor`` that drops assignments; every flash backward the
   model takes is at (192, 128), one a layer;
3. ``make_train_step`` at ``microbatches`` 1 and 2 against ``repro``'s
   unsharded step;
4. remat off, full and ``"dots"`` bit for bit, with the recompute's routing;
5. ``launch.train.main([..., "--arch", ARCH, "--reduced", "--device",
   "cpu"])`` to the end;
6. planted faults the checks must reject: a flash backward that drops ``D =
   sum(dO * O)`` at (192, 128) (``test_torch_train.py``'s ``drop_delta``),
   and the combine weights detached from the router.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
from repro_torch.launch import train as train_mod

import test_torch_moe_train as moe_train
from test_torch_train import BLOCK_TOL, LOSS_TOL, MODEL_TOL, drop_delta  # noqa: F401

ARCH = "deepseek-v2-lite-16b"
# deepseek-v2-lite's attention widths: the flash pair (192, 128).
WIDTHS = {"nope_head_dim": 128, "rope_head_dim": 64, "v_head_dim": 128}
# capacity_factor 1: cap = S * k / E = S / 2 rows an expert; drops occur.
DROPS = {**WIDTHS, "capacity_factor": 1.0}
# The batches' seed of the train-step check: from 12 to 22 one assignment
# of the 128 a step is a bf16 near-tie of the 4 experts that the packages'
# last bits route apart, and the routing check stops the comparison there.
STEP_SEED = 24
detached_combine = moe_train.detached_combine


@pytest.fixture
def flash_widths(monkeypatch):
    """The (q width, v width) of every flash backward call."""
    calls, bwd = [], fab.flash_attention_bwd

    def spying(q, k, v, out, dout, *args):
        calls.append((q.shape[-1], v.shape[-1]))
        return bwd(q, k, v, out, dout, *args)

    monkeypatch.setattr(fab, "flash_attention_bwd", spying)
    return calls


@pytest.mark.parametrize("layer,kind", [(0, "mla"), (1, "mla_moe")])
def test_block_gradients_match_jax_in_f32(layer, kind, flash_widths):
    errs = moe_train.block_errors(ARCH, layer, WIDTHS)
    assert max(errs.values()) <= BLOCK_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert any(name.startswith("attn/w_uk") for name in errs)
    assert ("moe/router/w" in errs) == (kind == "mla_moe")
    assert flash_widths == [(192, 128)]


def test_block_check_rejects_a_backward_without_d_at_192_128(drop_delta):
    drop_delta()
    errs = moe_train.block_errors(ARCH, 0, WIDTHS)
    assert max(errs.values()) > 100 * BLOCK_TOL


def test_block_check_rejects_combine_weights_detached_from_the_router(detached_combine):
    detached_combine()
    errs = moe_train.block_errors(ARCH, 1, WIDTHS)
    assert errs["moe/router/w"] > 100 * BLOCK_TOL


@pytest.mark.parametrize("over", [WIDTHS, DROPS], ids=["mla moe", "drops"])
def test_model_loss_and_gradients_match_jax_in_bf16(over, flash_widths):
    loss_err, aux_err, errs, drops = moe_train.model_errors(ARCH, over)
    assert loss_err <= LOSS_TOL and aux_err <= LOSS_TOL, (loss_err, aux_err)
    assert max(errs.values()) <= MODEL_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert (drops > 0) == (over is DROPS), drops
    # One backward a layer, every one at (192, 128).
    assert flash_widths == [(192, 128)] * 2


def test_model_check_rejects_a_backward_without_d_at_192_128(drop_delta):
    drop_delta()
    _, _, errs, _ = moe_train.model_errors(ARCH, WIDTHS)
    assert max(v for k, v in errs.items() if "/attn/" in k) > 3 * MODEL_TOL


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax_unsharded(microbatches):
    moe_train.train_step_errors(ARCH, microbatches, WIDTHS, seed=STEP_SEED)


def test_remat_policies_give_equal_gradients_and_routing():
    cfg, results = moe_train.remat_results(ARCH, DROPS)
    n = moe_train.n_moe_layers(cfg)
    for loss, grads, ids in results[1:]:
        assert torch.equal(loss, results[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, results[0][1]))
        assert len(ids) == 2 * n
        for fwd, again in zip(ids[:n], reversed(ids[n:])):
            np.testing.assert_array_equal(fwd, again)


def test_launch_train_runs_mla_moe_to_the_end(tmp_path, capsys):
    state, losses = train_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                                    "--steps", "4", "--global-batch", "2", "--seq-len", "16",
                                    "--checkpoint-every", "2", "--ckpt-dir", str(tmp_path)])
    assert int(state["step"]) == 4 and len(losses) == 4
    assert all(np.isfinite(losses))
    assert "done at step 4" in capsys.readouterr().out
