"""The reference's quantized-tier gates (``tests/test_quant_tiers.py``)
run on the port's ``core/tiers.py``, the one copied module that differs
from the reference (its fp8 codec casts through ``torch.float8_e4m3fn``
and keeps the payload as its ``uint8`` bit view).

Each reference test is repeated under its own name against the port's
module. Then the codecs are held against the reference on the same
inputs: every scheme's stored payloads, scales and byte ledger, and every
SSD file's members under each tier dtype and entropy codec, bit for bit.
"""
import io
import json
import os
import time

import numpy as np
import pytest

from repro.core import tiers as J
from repro_torch.core.eviction import LRUPolicy
from repro_torch.core.tiers import (_CODECS, FP8_BLOCK, QUANT_MIN_ELEMS,
                                    LoadInfo, QuantizedTree, TieredStore,
                                    dequantize_tree, int8_head_error_bounds,
                                    merge_load_infos, quant_error_bound,
                                    quantize_tree, stored_nbytes,
                                    tree_nbytes)


def _kv(seed=0, T=24, fill=None):
    rng = np.random.default_rng(seed)
    if fill is not None:
        k = np.full((2, T, 2, 4), float(fill), np.float32)
        return {"k": k, "v": k.copy()}
    return {"k": rng.standard_normal((2, T, 2, 4)).astype(np.float32),
            "v": rng.standard_normal((2, T, 2, 4)).astype(np.float32)}


def _conserved(ts):
    for tier, store in (("hbm", ts.hbm), ("cpu", ts.cpu),
                        ("ssd", ts.ssd_keys)):
        assert ts.used[tier] == sum(ts.sizes[k] for k in store), tier


# ---- codec (tests/test_quant_tiers.py, run on the port) --------------------

@pytest.mark.parametrize("scheme", ["int8", "fp8"])
def test_quantize_round_trip_within_error_bound(scheme):
    tree = _kv(1)
    q = quantize_tree(tree, scheme)
    assert isinstance(q, QuantizedTree) and q.scheme == scheme
    assert q.nbytes < tree_nbytes(tree) / 3
    out = dequantize_tree(q)
    for name in ("k", "v"):
        err = float(np.abs(out[name] - tree[name]).max())
        assert err <= quant_error_bound(tree[name], scheme), (name, err)


def test_quantize_is_at_most_once_and_fp32_is_identity():
    tree = _kv(2)
    assert quantize_tree(tree, "fp32") is tree
    q = quantize_tree(tree, "int8")
    assert quantize_tree(q, "fp8") is q
    assert quantize_tree(q, "int8") is q
    with pytest.raises(ValueError):
        quantize_tree(tree, "int4")


def test_small_and_integer_leaves_pass_through_raw():
    tree = {"kv": np.ones((4, QUANT_MIN_ELEMS), np.float32),
            "scale_sidecar": np.full(QUANT_MIN_ELEMS - 1, 0.37,
                                     np.float32),
            "pos": np.arange(QUANT_MIN_ELEMS, dtype=np.int32)}
    q = quantize_tree(tree, "int8")
    out = dequantize_tree(q)
    np.testing.assert_array_equal(out["scale_sidecar"],
                                  tree["scale_sidecar"])
    np.testing.assert_array_equal(out["pos"], tree["pos"])
    assert out["kv"].dtype == np.float32
    raw = sum(s is None for s in q.scales)
    assert raw == 2 and len(q.scales) == 3


def test_fp8_blockwise_scales_shape():
    """The reference skips this where ``ml_dtypes`` is missing; the port
    has no such fallback, so the scheme must stay fp8."""
    x = {"k": np.linspace(-4, 4, 3 * FP8_BLOCK + 7, dtype=np.float32)}
    q = quantize_tree(x, "fp8")
    assert q.scheme == "fp8"
    assert q.scales[0].shape == (4,)
    assert q.leaves[0].shape == x["k"].shape
    out = dequantize_tree(q)
    err = float(np.abs(out["k"] - x["k"]).max())
    assert err <= quant_error_bound(x["k"], "fp8")


def test_stored_nbytes_tracks_representation():
    tree = _kv(3)
    assert stored_nbytes(tree) == tree_nbytes(tree)
    q = quantize_tree(tree, "int8")
    assert stored_nbytes(q) == q.nbytes \
        == sum(p.nbytes for p in q.leaves) \
        + sum(s.nbytes for s in q.scales if s is not None)


def test_int8_per_head_scales_beat_per_tensor():
    rng = np.random.default_rng(8)
    T, H, D = 64, 4, 16
    x = rng.standard_normal((2, T, H, D)).astype(np.float32)
    x[..., 0, :] *= 20.0
    q = quantize_tree({"kv": x}, "int8")
    assert q.scales[0].shape == (H,)
    out = dequantize_tree(q)["kv"]
    err = np.abs(out - x)
    head_err = err.max(axis=tuple(i for i in range(x.ndim)
                                  if i != x.ndim - 2))
    bounds = int8_head_error_bounds(x)
    assert (head_err <= bounds).all()
    per_tensor = quant_error_bound(x, "int8")
    assert head_err[1:].max() < per_tensor / 4
    assert bounds[1:].max() < per_tensor / 4
    assert (head_err <= per_tensor).all()


def test_int8_legacy_scalar_scale_files_still_decode(tmp_path):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 24, 2, 4)).astype(np.float32)
    scale = np.float32(np.abs(x).max() / 127.0 + 1e-12)
    payload = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    legacy = {"a0": payload, "s0": np.asarray([scale], np.float32),
              "__struct__": np.frombuffer(
                  json.dumps({"kv": None}).encode(), np.uint8),
              "__nbytes__": np.int64(payload.nbytes + scale.nbytes),
              "__scheme__": np.frombuffer(b"int8", np.uint8)}
    np.savez(os.path.join(str(tmp_path), "old.npz"), **legacy)
    ts = TieredStore(1 << 20, 1 << 20, str(tmp_path), start_worker=False)
    out, _ = ts.get("old", promote=False)
    np.testing.assert_array_equal(out["kv"],
                                  payload.astype(np.float32) * scale)


# ---- SSD entropy coding ----------------------------------------------------

def test_tier_compress_validation(tmp_path):
    with pytest.raises(ValueError):
        TieredStore(1, 1, str(tmp_path / "a"), start_worker=False,
                    tier_compress={"cpu": "zlib"})
    with pytest.raises(ValueError):
        TieredStore(1, 1, str(tmp_path / "b"), start_worker=False,
                    tier_compress={"ssd": "lz4"})


def test_ssd_compress_round_trip_and_compressed_ledger(tmp_path):
    tree = {"k": np.zeros((2, 64, 2, 4), np.float32),
            "v": np.tile(np.arange(4, dtype=np.float32), (2, 64, 2, 1))}
    raw = tree_nbytes(tree)
    ts = TieredStore(1 << 20, 1 << 20, str(tmp_path), start_worker=False,
                     tier_compress={"ssd": "zstd"})
    if "zstd" not in _CODECS:
        assert ts.ssd_codec == "zlib"
        assert ts.stats["ssd_codec_fallbacks"] == 1
    else:
        assert ts.ssd_codec == "zstd"
    ts.put("a", tree, prefer="ssd")
    suffix = _CODECS[ts.ssd_codec][0]
    path = os.path.join(str(tmp_path), "a.npz" + suffix)
    assert os.path.exists(path)
    assert ts.sizes["a"] == os.path.getsize(path) < raw
    assert ts.used["ssd"] == ts.sizes["a"]
    assert ts.stats["ssd_compress_saved"] > 0
    out, info = ts.get("a", promote=False)
    np.testing.assert_array_equal(out["k"], tree["k"])
    np.testing.assert_array_equal(out["v"], tree["v"])
    assert info.nbytes == ts.sizes["a"]
    ts2 = TieredStore(1 << 20, 1 << 20, str(tmp_path / "q"),
                      start_worker=False,
                      tier_dtypes={"ssd": "int8"},
                      tier_compress={"ssd": "zlib"})
    big = {"kv": np.random.default_rng(0).standard_normal(
        (2, 64, 2, 4)).astype(np.float32)}
    ts2.put("b", big, prefer="ssd")
    got, _ = ts2.get("b", promote=False)
    err = float(np.abs(got["kv"] - big["kv"]).max())
    assert err <= quant_error_bound(big["kv"], "int8")


def test_ssd_compressed_files_survive_restart_and_legacy_load(tmp_path):
    tree = _kv(10)
    plain = TieredStore(1 << 20, 1 << 20, str(tmp_path),
                        start_worker=False)
    plain.put("leg", tree, prefer="ssd")
    ts = TieredStore(1 << 20, 1 << 20, str(tmp_path), start_worker=False,
                     tier_compress={"ssd": "zlib"})
    ts.put("c", tree, prefer="ssd")

    ts2 = TieredStore(1 << 20, 1 << 20, str(tmp_path), start_worker=False,
                      tier_compress={"ssd": "zlib"})
    assert ts2.where("c") == "ssd" and ts2.where("leg") == "ssd"
    assert ts2.sizes["c"] == os.path.getsize(
        os.path.join(str(tmp_path), "c.npz.dfl"))
    for key in ("c", "leg"):
        out, _ = ts2.get(key, promote=False)
        np.testing.assert_array_equal(out["k"], tree["k"])
        np.testing.assert_array_equal(out["v"], tree["v"])
    _conserved(ts2)

    ts2.put("leg", tree, prefer="ssd")
    names = sorted(f for f in os.listdir(str(tmp_path))
                   if f.startswith("leg"))
    assert names == ["leg.npz.dfl"]
    ts2.delete("c")
    assert not [f for f in os.listdir(str(tmp_path))
                if f.startswith("c.")]
    _conserved(ts2)


# ---- tiered store: ledger + round trips ------------------------------------

def test_tier_dtypes_validation(tmp_path):
    with pytest.raises(ValueError):
        TieredStore(1, 1, str(tmp_path / "a"), start_worker=False,
                    tier_dtypes={"hbm": "int8"})
    with pytest.raises(ValueError):
        TieredStore(1, 1, str(tmp_path / "b"), start_worker=False,
                    tier_dtypes={"cpu": "int4"})


def test_demote_encodes_and_ledger_counts_stored_bytes(tmp_path):
    tree = _kv(4)
    nb_raw = tree_nbytes(tree)
    ts = TieredStore(1 << 20, 1 << 20, str(tmp_path), start_worker=False,
                     tier_dtypes={"cpu": "int8", "ssd": "int8"})
    ts.put("a", tree)
    assert ts.sizes["a"] == nb_raw
    _conserved(ts)
    ts._demote("a", "hbm")
    assert ts.where("a") == "cpu"
    assert ts.sizes["a"] < nb_raw / 3
    assert ts.stats["quant_bytes_saved"] == nb_raw - ts.sizes["a"]
    _conserved(ts)
    ts._demote("a", "cpu")
    assert ts.where("a") == "ssd"
    with np.load(ts._ssd_path("a")) as z:
        payload = sum(z[f].nbytes for f in z.files
                      if not f.startswith("__"))
    assert ts.sizes["a"] == payload == ts.ssd_keys["a"]
    _conserved(ts)
    out, info = ts.get("a")
    assert ts.where("a") == "hbm"
    assert ts.sizes["a"] == nb_raw
    assert info.nbytes == payload
    _conserved(ts)
    for name in ("k", "v"):
        err = float(np.abs(out[name] - tree[name]).max())
        assert err <= quant_error_bound(tree[name], "int8"), name
    assert ts.stats["dequant_loads"] == 1


def test_quantized_npz_survives_restart_and_legacy_fp32_loads(tmp_path):
    tree = _kv(5)
    ts = TieredStore(1 << 20, 1 << 20, str(tmp_path), start_worker=False,
                     tier_dtypes={"ssd": "int8"})
    ts.put("q", tree, prefer="ssd")
    legacy = {"a0": tree["k"], "a1": tree["v"]}
    legacy["__struct__"] = np.frombuffer(
        json.dumps({"k": None, "v": None}).encode(), np.uint8)
    legacy["__nbytes__"] = np.int64(tree_nbytes(tree))
    np.savez(os.path.join(str(tmp_path), "old.npz"), **legacy)

    ts2 = TieredStore(1 << 20, 1 << 20, str(tmp_path), start_worker=False)
    assert ts2.where("q") == "ssd" and ts2.where("old") == "ssd"
    qv, _ = ts2.get("q", promote=False)
    for name in ("k", "v"):
        err = float(np.abs(qv[name] - tree[name]).max())
        assert err <= quant_error_bound(tree[name], "int8"), name
    ov, _ = ts2.get("old", promote=False)
    np.testing.assert_array_equal(ov["k"], tree["k"])
    np.testing.assert_array_equal(ov["v"], tree["v"])
    _conserved(ts2)


def test_fp32_default_stays_bit_exact(tmp_path):
    tree = _kv(6)
    ts = TieredStore(1 << 20, 1 << 20, str(tmp_path), start_worker=False)
    ts.put("a", tree)
    ts.flush()
    assert ts.where("a") == "ssd"
    out, _ = ts.get("a")
    np.testing.assert_array_equal(out["k"], tree["k"])
    assert ts.stats["quant_bytes_saved"] == 0
    assert ts.stats["dequant_loads"] == 0


# ---- satellite regressions -------------------------------------------------

def test_promote_false_hits_advance_lru_clock(tmp_path):
    nb = tree_nbytes(_kv(0))
    ts = TieredStore(1, 2 * nb, str(tmp_path), start_worker=False,
                     policy=LRUPolicy())
    ts.put("hot", _kv(0, fill=1.0))
    time.sleep(0.002)
    ts.put("cold", _kv(0, fill=2.0))
    time.sleep(0.002)
    before = ts.lru["hot"]
    _, info = ts.get("hot", promote=False)
    assert info.tier == "cpu"
    assert ts.lru["hot"] > before
    ts.put("new", _kv(0, fill=3.0))
    assert ts.where("hot") == "cpu"
    assert ts.where("cold") == "ssd"
    _conserved(ts)


def test_candidate_missing_size_uses_real_bytes(tmp_path):
    tree = _kv(7)
    ts = TieredStore(1 << 20, 1 << 20, str(tmp_path), start_worker=False)
    ts.put("a", tree)
    c = ts._candidate("a")
    assert c.nbytes == tree_nbytes(tree)
    del ts.sizes["a"]
    c = ts._candidate("a", ts.hbm["a"])
    assert c.nbytes == tree_nbytes(tree)
    q = quantize_tree(tree, "int8")
    assert ts._candidate("zz", q).nbytes == q.nbytes


def test_merge_load_infos_interval_union():
    mk = lambda t0, t1: LoadInfo("cpu", t1 - t0, 0.0, 8, t0=t0, t1=t1)  # noqa: E731
    m = merge_load_infos([mk(0.0, 1.0), mk(0.5, 1.5), mk(0.7, 0.9),
                          mk(3.0, 3.5)])
    assert abs(m.seconds_measured - 2.0) < 1e-12
    assert m.t0 == 0.0 and m.t1 == 3.5
    assert m.nbytes == 32
    legacy = merge_load_infos([LoadInfo("ssd", 0.25, 0.0, 8),
                               LoadInfo("cpu", 0.25, 0.0, 8)])
    assert abs(legacy.seconds_measured - 0.5) < 1e-12
    assert legacy.tier == "ssd"
    mixed = merge_load_infos([mk(0.0, 1.0), LoadInfo("cpu", 0.25, 0.0, 8)])
    assert abs(mixed.seconds_measured - 1.25) < 1e-12
    assert merge_load_infos([]) is None


def test_engine_surfaces_quant_stats(tmp_path):
    from repro_torch.serving.engine import EngineStats
    s = EngineStats()
    assert s.tier_quant_bytes_saved == 0 and s.tier_dequant_loads == 0


# ---- the port's codecs against the reference's, on the same inputs ---------

def _trees(seed):
    """KV-shaped leaves, an outlier head, a ragged fp8 block, a leaf over
    many binades, and leaves that stay raw (small, integer)."""
    rng = np.random.default_rng(seed)
    kv = rng.standard_normal((3, 40, 4, 16)).astype(np.float32)
    kv[..., 1, :] *= 30.0
    return {"kv": kv,
            "v": rng.standard_normal((3, 40, 4, 16)).astype(np.float32),
            "odd": rng.normal(size=(5, FP8_BLOCK + 9)).astype(np.float32),
            "wide": (rng.normal(size=700) * 10.0 ** rng.integers(
                -8, 4, 700)).astype(np.float32),
            "small": rng.normal(size=QUANT_MIN_ELEMS - 1).astype(np.float32),
            "pos": np.arange(QUANT_MIN_ELEMS, dtype=np.int32)}


def _same_bytes(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("scheme", ["int8", "fp8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_codec_stored_bytes_equal_reference(scheme, seed):
    """Payloads (fp8 as bits), scales, the stored-bytes ledger and the
    decoded values equal the reference's codec on the same tree."""
    tree = _trees(seed)
    qp, qr = quantize_tree(tree, scheme), J.quantize_tree(tree, scheme)
    assert qp.scheme == qr.scheme == scheme
    assert qp.struct == qr.struct
    assert qp.nbytes == qr.nbytes == stored_nbytes(qp) == \
        J.stored_nbytes(qr)
    assert len(qp.leaves) == len(qr.leaves)
    for pp, pr, sp, sr in zip(qp.leaves, qr.leaves, qp.scales, qr.scales):
        assert (sp is None) == (sr is None)
        _same_bytes(pp, np.asarray(pr))
        if sr is not None:
            _same_bytes(sp, sr)
    out_p, out_r = dequantize_tree(qp), J.dequantize_tree(qr)
    for name in tree:
        _same_bytes(out_p[name], np.asarray(out_r[name]))


def _ssd_members(ts, key):
    """The members of ``key``'s SSD file, decompressed if the store's
    codec compresses."""
    path = ts._ssd_path(key)
    src = path
    for suffix, _c, decompress in _CODECS.values():
        if path.endswith(suffix):
            with open(path, "rb") as f:
                src = io.BytesIO(decompress(f.read()))
            break
    with np.load(src) as z:
        return {n: z[n] for n in z.files}


@pytest.mark.parametrize("dtype", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("codec", ["none", "zlib", "zstd"])
def test_ssd_files_equal_reference(tmp_path, dtype, codec):
    """The same entry demoted to SSD by each package under the same tier
    dtype and entropy codec: every member of the two files is the same
    bytes, and an uncompressed file's ledger size is the same (a
    compressed one's can differ only by the zip timestamps inside)."""
    tree = _trees(3)
    kw = dict(start_worker=False, tier_dtypes={"ssd": dtype},
              tier_compress={"ssd": codec} if codec != "none" else None)
    port = TieredStore(1 << 20, 1 << 20, str(tmp_path / "p"), **kw)
    ref = J.TieredStore(1 << 20, 1 << 20, str(tmp_path / "r"), **kw)
    assert port.ssd_codec == ref.ssd_codec
    for ts in (port, ref):
        ts.put("a", tree, prefer="ssd")
    mp, mr = _ssd_members(port, "a"), _ssd_members(ref, "a")
    assert set(mp) == set(mr)
    for name in mr:
        _same_bytes(mp[name], mr[name])
    if port.ssd_codec == "none":
        assert port.sizes["a"] == ref.sizes["a"]
    op, _ = port.get("a", promote=False)
    orf, _ = ref.get("a", promote=False)
    for name in tree:
        _same_bytes(op[name], np.asarray(orf[name]))
    port.close()
    ref.close()
