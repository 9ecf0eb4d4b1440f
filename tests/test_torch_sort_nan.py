"""NaN float keys through the sort network, bit for bit against the JAX package.

The JAX package's compare-exchange (``_cmp_exchange`` of
``repro/kernels/merge_sort/merge_sort.py``) sends keys through
``jnp.minimum``/``jnp.maximum``.  On the CPU, in Pallas interpret mode, those
keep a NaN's bits (payload and sign) and spread it to both keys of its pair;
of two NaNs, ``min`` gives the first and ``max`` the second, swapped when the
first has its sign bit set.  The first test establishes that rule through a
Pallas call of ``_cmp_exchange`` itself, in both directions, for every pair
of a set of special keys.  The others hold the port's plain versions
(``sort_blocks_plain``, ``merge_pass_plain``, ``run_plan_plain`` and
``remop_sort_plain``) to the Pallas kernels on inputs with one NaN, NaNs of
several payloads, NaNs of both signs and NaNs beside signed zeros and
infinities; each case asserts that its classes of keys occur in the data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.kernels.merge_sort import merge_sort as jax_ms
from repro.kernels.merge_sort.ops import remop_sort as jax_remop_sort

from repro_torch.kernels.merge_sort import merge_sort as ms
from repro_torch.kernels.merge_sort.ops import remop_sort_plain

# Special keys by their float32 bits.
SPECIAL = {
    "nan": 0x7FC00000, "-nan": 0xFFC00000,  # the CPU's default NaN is -nan
    "nan:1": 0x7FC00001, "-nan:1": 0xFFC00001, "nan:2": 0x7FC00002,
    "snan": 0x7F800001, "-snan": 0xFF812345,
    "+0": 0x00000000, "-0": 0x80000000, "+inf": 0x7F800000, "-inf": 0xFF800000,
    "1": 0x3F800000, "-1": 0xBF800000,
}


def _f32(bits):
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def _is_nan(bits: int) -> bool:
    return (bits & 0x7FFFFFFF) > 0x7F800000


def jax_rule(a: int, b: int):
    """``(jnp.minimum(a, b), jnp.maximum(a, b))`` by bits, as the first test
    establishes it."""
    na, nb = _is_nan(a), _is_nan(b)
    if na and nb:
        return (b, a) if a >> 31 else (a, b)
    if na or nb:
        return (a, a) if na else (b, b)
    fa, fb = _f32([a, b])
    if fa == fb:  # equal keys differ in bits only as signed zeros
        return a | b, a & b
    return (a, b) if fa < fb else (b, a)


def _pallas_cmp_exchange(keys, values, descending: bool):
    """One stage at distance 1 of the JAX package's ``_cmp_exchange``, run by
    Pallas in interpret mode, as its kernels run it on the CPU."""
    g = keys.shape[0] // 2

    def kernel(k_ref, v_ref, ko_ref, vo_ref):
        k, v = jax_ms._cmp_exchange(k_ref[...], v_ref[...], 0, jnp.full((g,), descending))
        ko_ref[...] = k
        vo_ref[...] = v

    out = pl.pallas_call(
        kernel, interpret=True,
        out_shape=[jax.ShapeDtypeStruct(keys.shape, jnp.float32),
                   jax.ShapeDtypeStruct(values.shape, jnp.int32)],
    )(jnp.asarray(keys), jnp.asarray(values))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("descending", [False, True])
def test_jax_rule_for_nan_keys_and_the_plain_stage_follow_it(descending):
    names = list(SPECIAL)
    pairs = [(SPECIAL[a], SPECIAL[b]) for a in names for b in names]
    keys = _f32([x for pair in pairs for x in pair])
    values = np.arange(keys.shape[0], dtype=np.int32)
    want_k, want_v = _pallas_cmp_exchange(keys, values, descending)
    got_k, got_v = ms._cmp_exchange(
        torch.from_numpy(keys)[None], torch.from_numpy(values)[None], 0,
        torch.full((len(pairs),), descending))
    for i, (a, b) in enumerate(pairs):
        lo, hi = jax_rule(a, b)
        pair = want_k[2 * i:2 * i + 2].view(np.uint32).tolist()
        assert pair == ([hi, lo] if descending else [lo, hi]), (hex(a), hex(b), pair)
    # The rule, spelled out for the cases it was established on.
    rule = {(a, b): jax_rule(a, b) for a, b in pairs}
    for nan in ("-nan:1", "nan:2", "snan"):
        for x in ("1", "+0", "-0", "+inf", "-inf"):
            assert rule[SPECIAL[nan], SPECIAL[x]] == rule[SPECIAL[x], SPECIAL[nan]] == (
                SPECIAL[nan], SPECIAL[nan])
    assert rule[SPECIAL["-nan:1"], SPECIAL["nan:2"]] == (SPECIAL["nan:2"], SPECIAL["-nan:1"])
    assert rule[SPECIAL["nan:2"], SPECIAL["-nan:1"]] == (SPECIAL["nan:2"], SPECIAL["-nan:1"])
    assert rule[SPECIAL["nan:1"], SPECIAL["nan:2"]] == (SPECIAL["nan:1"], SPECIAL["nan:2"])
    assert rule[SPECIAL["-nan"], SPECIAL["-nan:1"]] == (SPECIAL["-nan:1"], SPECIAL["-nan"])
    # Values follow take_lo_first = first <= second: a pair holding a NaN swaps
    # ascending and stays descending.
    nan_pairs = np.array([_is_nan(a) or _is_nan(b) for a, b in pairs])
    moved = want_v.reshape(-1, 2)[:, 0] != values.reshape(-1, 2)[:, 0]
    assert (moved[nan_pairs] == (not descending)).all()
    assert got_k.numpy().tobytes() == want_k.tobytes()
    assert np.array_equal(got_v.numpy().reshape(-1), want_v)


def _classes(keys: np.ndarray) -> set:
    bits = keys.view(np.uint32).tolist()
    nans = {b for b in bits if _is_nan(b)}
    out = {name for name in ("+0", "-0", "+inf", "-inf") if SPECIAL[name] in bits}
    if nans:
        out.add(f"{len(nans)} NaN patterns")
        out |= {"+nan" if b >> 31 == 0 else "-nan" for b in nans}
    if len(nans) == 1 and sum(map(_is_nan, bits)) == 1:
        out.add("one NaN")
    return out


# case: (NaN bits placed, other specials placed, classes the keys must hold)
CASES = {
    "one": ([SPECIAL["-nan"]], [], {"one NaN", "-nan"}),
    "payloads": ([SPECIAL[x] for x in ("nan:1", "nan:2", "snan", "nan")], [],
                 {"4 NaN patterns", "+nan"}),
    "signs": ([SPECIAL[x] for x in ("nan", "-nan", "-nan:1", "-snan")], [],
              {"4 NaN patterns", "+nan", "-nan"}),
    "beside": ([SPECIAL[x] for x in ("-nan:1", "nan:2")],
               [SPECIAL[x] for x in ("+0", "-0", "+inf", "-inf")],
               {"2 NaN patterns", "+nan", "-nan", "+0", "-0", "+inf", "-inf"}),
}
N = 256


def _keys(case: str, seed: int, n: int = N) -> np.ndarray:
    """Tied keys in [-4, 4] with the case's NaNs at a few places and its
    other specials at many, some NaNs right beside them."""
    rng = np.random.default_rng(seed)
    nans, others, want = CASES[case]
    bits = np.asarray(rng.integers(-4, 5, size=n).astype(np.float32)).view(np.uint32).copy()
    if others:
        spots = rng.random(n) < 0.25
        bits[spots] = rng.choice(np.array(others, np.uint32), int(spots.sum()))
    places = rng.choice(n, size=len(nans), replace=False)
    bits[places] = nans
    for p in places[: len(others)]:  # a NaN beside each kind of special key
        bits[p ^ 1] = others[int(p) % len(others)]
    keys = bits.view(np.float32)
    assert want <= _classes(keys), (case, want, _classes(keys))
    return keys


def _assert_bits(want, got, what):
    for a, b in zip(want, got):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, what
        assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["sort_blocks", "merge_pass"])
def test_plain_versions_and_emulation_match_pallas_on_nan_keys(kind, case):
    """Blocks 2^1..2^6 or runs 2^0..2^5 at n = 256: the plain version, the
    wrapper's CPU route and the tile-by-tile emulation of the kernel's plan
    (tiles of 2^4 and 2^5, the strided route included) against Pallas."""
    spread = 0
    for e in range(1, 7) if kind == "sort_blocks" else range(0, 6):
        arg = 1 << e
        keys = _keys(case, seed=e)
        values = np.random.default_rng(100 + e).permutation(N).astype(np.int32)
        if kind == "merge_pass":
            # Sorted runs, NaNs last; by index, since np.sort may make NaNs canonical.
            runs = keys.reshape(-1, arg)
            keys = np.take_along_axis(runs, np.argsort(runs, axis=1, kind="stable"), 1).reshape(-1)
            assert CASES[case][2] <= _classes(keys)
            want = jax_ms.merge_pass(jnp.asarray(keys), jnp.asarray(values), arg, interpret=True)
            plain, wrapper = ms.merge_pass_plain, ms.merge_pass
        else:
            want = jax_ms.sort_blocks(jnp.asarray(keys), jnp.asarray(values), arg, interpret=True)
            plain, wrapper = ms.sort_blocks_plain, ms.sort_blocks
        k, v = torch.from_numpy(keys), torch.from_numpy(values)
        _assert_bits(want, plain(k, v, arg), (kind, case, arg, "plain"))
        _assert_bits(want, wrapper(k, v, arg), (kind, case, arg, "wrapper"))
        for chunk in (1 << 4, 1 << 5):
            launches = ms.plan(N, kind, arg, chunk)
            _assert_bits(want, ms.run_plan_plain(k, v, launches), (kind, case, arg, launches))
        # The NaNs spread, each with the bits of a NaN of the input.
        out = np.asarray(want[0]).view(np.uint32)
        nan_out = {b for b in out.tolist() if _is_nan(b)}
        assert nan_out <= {b for b in keys.view(np.uint32).tolist() if _is_nan(b)}
        spread += sum(map(_is_nan, out.tolist())) > sum(map(_is_nan, keys.view(np.uint32).tolist()))
    assert spread > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_remop_sort_plain_matches_pallas_on_nan_keys(case):
    """The whole sort, padded with +inf to a power of two, in-core runs of 16
    then merges: the plain composition against the JAX package's."""
    keys = _keys(case, seed=7, n=200)
    values = np.random.default_rng(8).permutation(200).astype(np.int32)
    want = jax_remop_sort(jnp.asarray(keys), jnp.asarray(values), run_items=16)
    got = remop_sort_plain(torch.from_numpy(keys), torch.from_numpy(values), run_items=16)
    _assert_bits(want, got, case)
    assert any(map(_is_nan, np.asarray(want[0]).view(np.uint32).tolist()))
