"""The port's device statistics backend (biscuit_torch/ops/roc_device.py,
ops/threshold_device.py and the dispatch of threshold.py), run with
``device="cpu"``, against the JAX package's device backend
(biscuit_tpu/ops/roc_jax.py, ops/threshold_device.py on the CPU) and the
host path.

Tolerances: thresholds, AUCs and ``apply`` results within 1e-6 of the
host and of the JAX backend (tests/test_threshold_device.py's ``_cmp``);
on frames with f32 columns ``tile_pred``/``tile_uq`` equal the host's
exactly (the device holds the tile columns as f32, as the JAX backend
does, so on f64 frames a tile threshold is the host's score rounded to
f32). The ops: group means within 1e-12 of pandas (f64 sums), AUC and
DeLong within 1e-9 of the host statistics (f64 on both sides; the JAX
ops are f32 and held within their own tests' bounds).
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from test_reference_parity import FRAME_SPECS, make_frame
from test_threshold_device import _cmp

import biscuit_torch.threshold as port
import biscuit_tpu.threshold as jax_th
from biscuit_torch.ops import roc_device as rd
from biscuit_torch.ops import threshold_device as td
from biscuit_torch.stats import roc as host_roc
from biscuit_tpu import delong as host_delong
from biscuit_tpu.ops import roc_jax

torch.set_num_threads(1)

CPU = {"device": "cpu"}


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _labels_scores(seed, n=400, ties=None):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    y[:2] = (0, 1)
    s = rng.random(n) + 0.4 * y
    if ties:
        s = np.round(s * ties) / ties
    return y, s.astype(np.float32)


# ---------------------------------------------------------------------------
# roc_device against roc_jax and the host statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,ties", [(0, None), (1, 10), (2, 3)])
def test_auc(seed, ties):
    y, s = _labels_scores(seed, ties=ties)
    got = float(rd.auc(_t(y), _t(s)))
    assert got == pytest.approx(host_roc.auc_score(y, s), abs=1e-9)
    assert got == pytest.approx(float(roc_jax.auc_jax(
        jnp.asarray(y), jnp.asarray(s))), abs=1e-6)
    # Padded rows are dropped by the mask, whatever they hold.
    mask = np.r_[np.ones(len(y)), np.zeros(50)]
    y_pad, s_pad = np.r_[y, np.ones(50, int)], np.r_[s, np.full(50, 9.0,
                                                                 np.float32)]
    assert float(rd.auc(_t(y_pad), _t(s_pad), _t(mask))) == pytest.approx(
        got, abs=1e-12)
    assert np.isnan(float(rd.auc(_t(np.ones(5)), _t(s[:5]))))


@pytest.mark.parametrize("seed,ties", [(0, None), (3, 20), (4, 5)])
def test_youden_candidates_resolve_to_the_host_threshold(seed, ties):
    """Exact-tie frames included: the candidates with their integer
    counts, re-evaluated as the host does, give the host's threshold bit
    for bit; the candidates equal the JAX op's."""
    y, s = _labels_scores(seed, ties=ties)
    cand = rd.youden_candidates(_t(y), _t(s))
    fpr, tpr, thr = host_roc.roc_curve(y, s)
    want = host_roc.youden_threshold(fpr, tpr, thr)
    assert td._resolve_youden(cand) == want
    ref = roc_jax.youden_candidates_jax(jnp.asarray(y), jnp.asarray(s))
    count = int(cand["count"])
    assert count == int(ref["count"])
    for k in ("tps", "fps", "score", "keep"):
        np.testing.assert_array_equal(cand[k].numpy()[:count],
                                      np.asarray(ref[k])[:count], err_msg=k)
    assert int(cand["m"]) == int(ref["m"]) and int(cand["n"]) == int(ref["n"])


@pytest.mark.parametrize("seed", [0, 5])
def test_youden_and_uncertainty_thresholds(seed):
    y, s = _labels_scores(seed)
    thr, j = rd.youden_threshold(_t(y), _t(s))
    # J is f64 here and f32 in the JAX op, whose argmax can land on
    # another point of a near-tie: the threshold is held to the host's,
    # J to both.
    fpr, tpr, t = host_roc.roc_curve(y, s)
    assert float(thr) == host_roc.youden_threshold(fpr, tpr, t)
    assert float(j) == pytest.approx(np.max(tpr - fpr), abs=1e-12)
    _thr, want_j = roc_jax.youden_threshold_jax(jnp.asarray(y),
                                                jnp.asarray(s))
    assert float(j) == pytest.approx(float(want_j), abs=1e-6)
    u_thr, _ = rd.uncertainty_threshold(_t(y), _t(s))
    assert float(u_thr) == float(thr)
    # No positive J: the +inf origin point, as the host picks.
    inf_thr, inf_j = rd.youden_threshold(_t(np.array([1, 0])),
                                         _t(np.array([0.1, 0.9])))
    assert float(inf_thr) == np.inf and float(inf_j) == 0.0


def test_group_reduce_and_segment_mean():
    rng = np.random.default_rng(2)
    n, groups = 500, 17
    seg = rng.integers(0, groups, n)
    yp, u = rng.random(n), rng.random(n)
    yt = (seg % 2).astype(np.float32)
    mask = (rng.random(n) < 0.8).astype(np.float32)
    out = rd.group_reduce(_t(yt), _t(yp), _t(u), _t(seg), groups, _t(mask))
    df = pd.DataFrame({"seg": seg, "yp": yp, "yt": yt, "u": u})[mask > 0]
    g = df.groupby("seg").mean()
    np.testing.assert_allclose(out["y_pred"].numpy()[g.index], g["yp"],
                               rtol=1e-12)
    np.testing.assert_allclose(out["uncertainty"].numpy()[g.index], g["u"],
                               rtol=1e-12)
    np.testing.assert_array_equal(out["y_true"].numpy()[g.index],
                                  g["yt"].to_numpy().astype(np.uint8))
    np.testing.assert_array_equal(out["count"].numpy()[g.index],
                                  df.groupby("seg").size())
    ref = roc_jax.group_reduce(jnp.asarray(yt), jnp.asarray(yp),
                               jnp.asarray(u), jnp.asarray(seg), groups,
                               jnp.asarray(mask))
    np.testing.assert_allclose(out["y_pred"].numpy(),
                               np.asarray(ref["y_pred"]), atol=1e-6)
    mean, counts = rd.segment_mean(_t(u), _t(seg), groups, _t(mask))
    np.testing.assert_array_equal(mean.numpy(), out["uncertainty"].numpy())
    np.testing.assert_array_equal(counts.numpy(), out["count"].numpy())
    # The same table again, bit for bit.
    again = rd.group_reduce(_t(yt), _t(yp), _t(u), _t(seg), groups,
                            _t(mask))
    for k in out:
        assert torch.equal(out[k], again[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_delong_at_group_scale(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 300)
    a = np.round(rng.random(300) + 0.4 * y, 2)     # ties + signal
    b = rng.random(300) + 0.2 * y
    h_auc, h_var = host_delong.delong_roc_variance(y, a)
    d_auc, d_var = rd.delong_variance(_t(y), _t(a))
    assert float(d_auc) == pytest.approx(h_auc, abs=1e-9)
    assert float(d_var) == pytest.approx(float(np.squeeze(h_var)), rel=1e-9)
    j_auc, j_var = roc_jax.delong_variance_jax(jnp.asarray(y),
                                               jnp.asarray(a))
    assert float(d_var) == pytest.approx(float(j_var), rel=1e-4)
    h = float(np.squeeze(host_delong.delong_roc_test(y, a, b)))
    assert float(rd.delong_test(_t(y), _t(a), _t(b))) == pytest.approx(
        h, rel=1e-9)
    assert float(rd.delong_test(_t(y), _t(a), _t(b))) == pytest.approx(
        float(roc_jax.delong_test_jax(jnp.asarray(y), jnp.asarray(a),
                                      jnp.asarray(b))), rel=1e-3, abs=1e-3)
    # Padded rows masked out.
    mask = np.r_[np.ones(300), np.zeros(20)]
    pv = rd.delong_variance(_t(np.r_[y, np.ones(20, int)]),
                            _t(np.r_[a, rng.random(20)]), _t(mask))
    assert float(pv[1]) == pytest.approx(float(d_var), rel=1e-12)


def test_apply_thresholds_matches_host():
    df, _patients = make_frame(seed=2, noise=0.2, n_slides=20)
    params = dict(tile_uq=0.2, slide_uq=0.18, tile_pred=0.5, slide_pred=0.5)
    host, _ = port.apply(df.copy(), backend="host", **params)
    slides = {s: i for i, s in enumerate(pd.unique(df["slide"]))}
    seg = df["slide"].map(slides).to_numpy()
    dev = rd.apply_thresholds(
        _t(df["y_true"].to_numpy()), _t(df["y_pred"].to_numpy()),
        _t(df["uncertainty"].to_numpy()), _t(seg), len(slides), **params)
    ref = roc_jax.apply_thresholds_jax(
        jnp.asarray(df["y_true"].to_numpy()),
        jnp.asarray(df["y_pred"].to_numpy()),
        jnp.asarray(df["uncertainty"].to_numpy()), jnp.asarray(seg),
        len(slides), **params)
    for k in host:
        assert float(dev[k]) == pytest.approx(host[k], abs=1e-9), k
        assert float(dev[k]) == pytest.approx(float(ref[k]), abs=1e-6), k


# ---------------------------------------------------------------------------
# detect / apply / from_cv with backend="device" on the CPU
# ---------------------------------------------------------------------------

def _three(fn, df, **kw):
    """(host, port device on the CPU, JAX device) results of one call, or
    None for all three when the host raises ValueError (the device paths
    must raise it too)."""
    out = []
    for mod, extra in ((port, {"backend": "host"}),
                       (port, {"backend": "device", **CPU}),
                       (jax_th, {"backend": "device"})):
        try:
            out.append(getattr(mod, fn)(df.copy(), **kw, **extra))
        except ValueError:
            out.append(None)
    assert (out[0] is None) == (out[1] is None) == (out[2] is None)
    return out


@pytest.mark.parametrize("spec", FRAME_SPECS, ids=lambda s: f"seed{s['seed']}")
def test_detect_parity(spec):
    df, patients = make_frame(**spec)
    host, dev, ref = _three("detect", df, patients=patients)
    if host is None:
        return
    for other in (host, ref):
        _cmp(other[0], dev[0], "thresholds")
        _cmp(other[1], dev[1], "auc")


@pytest.mark.parametrize("variant", [
    dict(tile_uq=0.2), dict(tile_uq=None), dict(slide_uq=0.4),
    dict(tile_pred=0.5, slide_pred=0.5),
    dict(tile_uq=0.25, slide_uq=None, slide_pred=0.45)],
    ids=["fixed-tuq", "no-tuq", "fixed-suq", "fixed-preds", "mixed"])
def test_detect_variants(variant):
    df, patients = make_frame(seed=3, quantize_pred=1)
    host, dev, ref = _three("detect", df, patients=patients, **variant)
    for other in (host, ref):
        _cmp(other[0], dev[0], "thresholds")
        _cmp(other[1], dev[1], "auc")


@pytest.mark.parametrize("level", ["slide", "patient"])
@pytest.mark.parametrize("keep", ["high_confidence", "low_confidence"])
@pytest.mark.parametrize("spec", FRAME_SPECS[:6],
                         ids=lambda s: f"seed{s['seed']}")
def test_apply_parity(spec, level, keep):
    """detect -> apply on each backend with its own thresholds, as a run
    uses one backend (tests/test_threshold_device.py)."""
    df, patients = make_frame(**spec)
    host_t, dev_t, _ref = _three("detect", df, patients=patients)
    if host_t is None or host_t[0]["tile_uq"] is None:
        return
    kw = dict(keep=keep, patients=patients, level=level)
    h_res, h_df = port.apply(df.copy(), backend="host", **host_t[0], **kw)
    d_res, d_df = port.apply(df.copy(), backend="device", **CPU,
                             **dev_t[0], **kw)
    j_res, _ = jax_th.apply(df.copy(), backend="device", **_ref[0], **kw)
    _cmp(h_res, d_res, "results")
    _cmp(j_res, d_res, "results")
    if h_df is None:
        assert d_df is None
        return
    assert list(h_df[level]) == list(d_df[level])
    for col in ("y_true", "y_pred", "uncertainty", "error", "y_pred_bin"):
        np.testing.assert_allclose(h_df[col].to_numpy(np.float64),
                                   d_df[col].to_numpy(np.float64),
                                   atol=1e-6, err_msg=col)


def _f32_frame(seed, n_slides=30, tiles=60):
    """A frame with f32 score columns quantized to 1/1024, so exact-J ties
    occur, and a fifth of the slides hard (mostly wrong tiles)."""
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(n_slides):
        y = s % 2
        p_ok = 0.2 if s % 5 == 0 else 0.85     # slides 0, 5, 10, ... hard
        ok = rng.random(tiles) < p_ok
        pred = np.where(ok == bool(y), rng.uniform(0.5, 1, tiles),
                        rng.uniform(0, 0.5, tiles))
        unc = np.where(ok & (rng.random(tiles) < 0.9),
                       rng.uniform(0, 0.2, tiles),
                       rng.uniform(0.1, 0.5, tiles))
        rows.append(pd.DataFrame({
            "slide": f"s{s}", "patient": f"p{s // 2}", "y_true": y,
            "y_pred": np.round(pred * 1024) / 1024,
            "uncertainty": np.round(unc * 1024) / 1024}))
    df = pd.concat(rows, ignore_index=True)
    for c in ("y_true", "y_pred", "uncertainty"):
        df[c] = df[c].astype(np.float32)
    return df


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_frames_give_the_host_tile_thresholds_exactly(seed):
    dfs = [_f32_frame(seed * 10 + k) for k in range(3)]
    for df in dfs:
        host, dev, ref = _three("detect", df)
        assert dev[0]["tile_pred"] == host[0]["tile_pred"]
        assert dev[0]["tile_uq"] == host[0]["tile_uq"]
        for other in (host, ref):
            _cmp(other[0], dev[0], "thresholds")
            _cmp(other[1], dev[1], "auc")
    got = port.from_cv([d.copy() for d in dfs], backend="device", **CPU)
    want = port.from_cv([d.copy() for d in dfs], backend="host")
    ref = jax_th.from_cv([d.copy() for d in dfs], backend="device")
    assert got["tile_uq"] == want["tile_uq"]
    assert got["tile_pred"] == want["tile_pred"]
    _cmp(want, got, "from_cv")
    _cmp(ref, got, "from_cv")
    ext = _f32_frame(seed + 100)
    patients = dict(zip(ext["slide"], ext["patient"]))
    for level in ("slide", "patient"):
        kw = dict(patients=patients, level=level)
        h, _ = port.apply(ext.copy(), backend="host", **want, **kw)
        d, _ = port.apply(ext.copy(), backend="device", **CPU, **got, **kw)
        _cmp(h, d, f"apply-{level}")


# ---------------------------------------------------------------------------
# Fallbacks, degrades and dispatch
# ---------------------------------------------------------------------------

def _fell_back(monkeypatch, call):
    """Run ``call`` with detect_device/apply_device spied on: returns
    (result, the HostFallback reasons raised)."""
    reasons = []
    for name in ("detect_device", "apply_device"):
        real = getattr(td, name)

        def spy(*a, _real=real, **k):
            try:
                return _real(*a, **k)
            except td.HostFallback as e:
                reasons.append(str(e))
                raise
        monkeypatch.setattr(td, name, spy)
    return call(), reasons


@pytest.mark.parametrize("case,reason", [
    ("empty", "empty frame"), ("nonbinary", "non-binary labels"),
    ("oneclass", "single-class tile labels"),
    ("nan_unc", "NaN uncertainty")])
def test_host_fallback_reasons(case, reason, monkeypatch):
    df, patients = make_frame(seed=0)
    if case == "empty":
        df = df.iloc[:0]
    elif case == "nonbinary":
        df.loc[df.index[0], "y_true"] = 2
    elif case == "oneclass":
        df["y_true"] = 1
    else:
        df.loc[df.index[0], "uncertainty"] = np.nan

    def both():
        try:
            return port.detect(df.copy(), backend="device", **CPU)
        except Exception as e:  # the host's own exception
            return type(e)
    got, reasons = _fell_back(monkeypatch, both)
    assert reasons == [reason]
    try:
        want = port.detect(df.copy(), backend="host")
    except Exception as e:
        want = type(e)
    if isinstance(want, type):
        assert got is want
    else:
        _cmp(want[0], got[0])
        _cmp(want[1], got[1])


def test_argument_fallbacks(monkeypatch):
    df, patients = make_frame(seed=0)
    for call, reason in (
        (lambda: port.detect(df.copy(), tile_pred="x", backend="device",
                             **CPU), "non-numeric prediction threshold"),
        (lambda: port.apply(df.copy(), 0.2, 0.1, slide_pred="detect",
                            backend="device", **CPU),
         "non-numeric slide_pred"),
        (lambda: port.apply(df.copy(), "x", 0.1, backend="device", **CPU),
         "non-numeric truthy tile_uq"),
    ):
        try:
            _, reasons = _fell_back(monkeypatch, call)
        except (TypeError, ValueError):     # the host's own error
            reasons = None
        assert reasons is None or reasons == [reason]


def test_candidate_overflow_and_row_screen_fall_back(monkeypatch, caplog):
    """More tied candidates than _CAND_K, and frames past the row budget,
    run on the host with a debug line; the result is the host's."""
    import logging

    # Alternating labels down the score order: every positive closes a
    # curve point of the same J, 20 tied candidates.
    n = 40
    df = pd.DataFrame({
        "slide": [f"s{i % 4}" for i in range(n)],
        "y_true": [1 - i % 2 for i in range(n)],
        "y_pred": np.linspace(1, 0, n),
        "uncertainty": np.linspace(0, 0.5, n) % 0.3})
    patients = {f"s{i}": f"p{i}" for i in range(4)}
    want = port.detect(df.copy(), patients=patients, backend="host")
    monkeypatch.setattr(td, "_CAND_K", 8)
    with caplog.at_level(logging.DEBUG, logger="biscuit_torch"):
        got, reasons = _fell_back(monkeypatch, lambda: port.detect(
            df.copy(), patients=patients, backend="device", **CPU))
    assert reasons and reasons[0].startswith("youden candidate overflow")
    assert "fell back to host" in caplog.text
    assert got == want
    monkeypatch.setattr(td, "_CAND_K", 128)
    monkeypatch.setattr(td, "_MAX_ROWS", len(df))
    got, reasons = _fell_back(monkeypatch, lambda: port.detect(
        df.copy(), patients=patients, backend="device", **CPU))
    assert reasons == ["frame exceeds the 2**24-row budget"] and got == want


def test_nan_predictions_degrade(monkeypatch):
    df, patients = make_frame(seed=0)
    df.loc[df.index[3], "y_pred"] = np.nan
    empty = {k: None for k in ("tile_uq", "slide_uq", "tile_pred",
                               "slide_pred")}
    for backend in ("host", "device"):
        assert port.detect(df.copy(), backend=backend, **CPU) == (empty, None)


def test_errors_propagate_and_are_never_a_host_run(monkeypatch):
    df, _patients = make_frame(seed=0)

    def boom(*a, **k):
        raise RuntimeError("CUDA error: out of memory")
    monkeypatch.setattr(td, "group_reduce", boom)
    with pytest.raises(RuntimeError, match="out of memory"):
        port.detect(df.copy(), backend="device", **CPU)


def test_dispatch(monkeypatch):
    """backend wins; else BISCUIT_DEVICE_STATS; else the row count against
    BISCUIT_DEVICE_STATS_MIN_ROWS, except plot=True. The device backend
    with device=None goes to the card, and without one it raises, naming
    both ways out."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df, patients = make_frame(seed=0)
    no_card = pytest.raises(RuntimeError, match="device='cpu'.*backend='host'")
    with no_card:
        port.detect(df.copy(), backend="device")
    with no_card:
        port.apply(df.copy(), 0.2, 0.1, backend="device")
    with no_card:
        port.from_cv([df.copy()], backend="device")
    with pytest.raises(ValueError, match="backend must be"):
        port.detect(df.copy(), backend="gpu")
    host = port.detect(df.copy(), patients=patients)        # < 1M rows
    monkeypatch.setenv("BISCUIT_DEVICE_STATS_MIN_ROWS", str(len(df)))
    with no_card:
        port.detect(df.copy(), patients=patients)
    _cmp(host[0], port.detect(df.copy(), patients=patients, **CPU)[0])
    monkeypatch.setattr(port, "plot_uncertainty", lambda *a, **k: None)
    port.detect(df.copy(), patients=patients, plot=True)     # host: plot
    monkeypatch.setenv("BISCUIT_DEVICE_STATS", "0")
    assert port.detect(df.copy(), patients=patients) == host
    monkeypatch.setenv("BISCUIT_DEVICE_STATS", "1")
    monkeypatch.delenv("BISCUIT_DEVICE_STATS_MIN_ROWS")
    with no_card:
        port.detect(df.copy(), patients=patients)
    _cmp(host[0], port.detect(df.copy(), patients=patients, **CPU)[0])
