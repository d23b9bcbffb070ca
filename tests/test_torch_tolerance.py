"""The serving tolerance of the port (``serve_federated.within_tolerance``)
and the wire-message records it reads, on the CPU.

A lossy route's large score error is accepted only in a row whose two
sends' wire messages differ (a codec decision flipped), and such rows
must stay rare; a large error in a row whose messages agree fails.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import codec as wire
from repro_torch.core.encoders import EncoderConfig, fusion_init, init_client_models
from repro_torch.core.inference import InferenceRequest, predict
from repro_torch.core.serving import ServingConfig, ServingEngine
from repro_torch.data.synthetic import make_task
from repro_torch.launch import serve_federated as sf


def _run(rows=300, out=25, seed=0):
    """Errors of a lossy run at f32-rounding size, and no flipped row."""
    rng = np.random.default_rng(seed)
    errs = [rng.uniform(0, 5e-7, (n, out)) for n in np.full(rows // 3, 3)]
    flips = [np.zeros(len(e), bool) for e in errs]
    return errs, flips


def test_one_flipped_row_with_a_large_error_passes():
    """The case met on the card: a top-k decision of one score download
    flipped, so one score is 0 on one side and 0.575 on the other."""
    errs, flips = _run()
    errs[7][1, 4] = 0.575
    flips[7][1] = True
    tol = sf.within_tolerance(errs, lossy=True, flips=flips)
    assert tol.ok, tol
    assert tol.max_err == pytest.approx(0.575)
    assert tol.flipped == pytest.approx(1 / 300)


def test_a_large_error_where_the_messages_agree_fails():
    errs, flips = _run()
    errs[7][1, 4] = 0.575
    flips[3][0] = True  # another row flipped: it does not explain this one
    tol = sf.within_tolerance(errs, lossy=True, flips=flips)
    assert not tol.ok and "messages agree" in tol.why
    errs, flips = _run()
    errs[2][0, 0] = 2e-5  # small, but beyond ATOL_EXACT, messages equal
    assert not sf.within_tolerance(errs, lossy=True, flips=flips).ok


def test_too_many_flipped_rows_fail():
    errs, flips = _run()
    assert sf.MAX_FLIPPED == 0.01
    for i in range(4):  # 4 of 300 rows: above MAX_FLIPPED
        flips[i][0] = True
    tol = sf.within_tolerance(errs, lossy=True, flips=flips)
    assert not tol.ok and "differing messages" in tol.why
    flips[0][0] = flips[1][0] = False  # 2 of 300: within
    assert sf.within_tolerance(errs, lossy=True, flips=flips).ok
    # the recurrent encoder's card-vs-CPU cap
    assert sf.MAX_FLIPPED_RECURRENT == 0.03
    for i in range(9):  # 9 of 300: within 3%
        flips[i][0] = True
    assert not sf.within_tolerance(errs, lossy=True, flips=flips).ok
    assert sf.within_tolerance(errs, lossy=True, flips=flips,
                               max_flipped=sf.MAX_FLIPPED_RECURRENT).ok
    flips[9][0] = True  # 10 of 300: above
    tol = sf.within_tolerance(errs, lossy=True, flips=flips,
                              max_flipped=sf.MAX_FLIPPED_RECURRENT)
    assert not tol.ok and "differing messages" in tol.why


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("compared", [True, False])
@pytest.mark.parametrize("flipped_row", [False, True])
def test_a_non_finite_error_fails(bad, compared, flipped_row):
    """A NaN or inf score on either side fails, lossy or not, whether or
    not the messages were compared, and also in a row whose messages
    differ; one such score is far fewer than 1% of the run's."""
    errs, flips = _run()
    errs[7][1, 4] = bad
    flips[7][1] = flipped_row
    for lossy in (True, False):
        tol = sf.within_tolerance(errs, lossy=lossy,
                                  flips=flips if compared and lossy else None)
        assert not tol.ok and "non-finite" in tol.why, tol


def test_share_within_exact_still_holds():
    """Flipped rows may carry large errors, but FRAC_LOSSY of the scores
    must stay within ATOL_EXACT."""
    errs, flips = _run()
    for e, f in zip(errs[:2], flips[:2]):  # 2 of 300 rows: 50 of 7500 scores
        e[0] = 1e-3
        f[0] = True
    assert sf.within_tolerance(errs, lossy=True, flips=flips).ok
    errs, flips = _run(rows=30)
    errs[0][0] = 1e-3  # 1 of 30 rows: 25 of 750 scores off
    flips[0][0] = True
    tol = sf.within_tolerance(errs, lossy=True, flips=flips)
    assert not tol.ok and f"within {sf.ATOL_EXACT}" in tol.why


def test_local_routes_and_uncompared_messages():
    errs, _ = _run()
    assert sf.within_tolerance(errs, lossy=False).ok
    errs[0][0, 0] = 2e-5
    assert not sf.within_tolerance(errs, lossy=False).ok
    # messages not compared (port against the reference): the run-level
    # bound, all within ATOL_LOSSY and FRAC_LOSSY within ATOL_EXACT
    errs, _ = _run()
    errs[0][0, 0] = 5e-3
    assert sf.within_tolerance(errs, lossy=True).ok
    errs[0][0, 0] = 0.575
    assert not sf.within_tolerance(errs, lossy=True).ok
    assert sf.within_tolerance([], lossy=True).ok
    with pytest.raises(ValueError, match="message flags"):
        sf.within_tolerance(errs, lossy=True, flips=[np.zeros(1, bool)])


def test_message_codes_see_a_flipped_top_k_decision():
    """Two sends of one score row that differ in the last ulp of the 7th
    and 8th largest entries keep different top-k sets; wire_diff names
    the message and the kind of difference."""
    cfg = wire.make_codec("int8_topk")
    row = torch.linspace(0.01, 0.3, 25)
    row[:6] = torch.tensor([0.9, 0.85, 0.8, 0.75, 0.7, 0.65])
    row[6] = row[7] = 0.5  # a tie for 7th place (k = 7 of 25) ...
    a, b = row.clone(), row.clone()
    b[7] = torch.nextafter(b[7], torch.tensor(1.0))  # ... broken by 1 ulp
    ca, cb = wire.message_codes(a[None], cfg), wire.message_codes(b[None], cfg)
    assert ca.dtype == torch.int16 and tuple(ca.shape) == (1, 25)
    assert int((ca != 0).sum()) == 8 and int((cb != 0).sum()) == 7  # ties kept
    d = 4
    codes_a = torch.cat([torch.zeros(1, 2 * d, dtype=torch.int16), ca], 1)
    codes_b = torch.cat([torch.zeros(1, 2 * d, dtype=torch.int16), cb], 1)
    assert sf.message_flips(codes_a, codes_b).tolist() == [True]
    assert sf.message_flips(codes_a, codes_a).tolist() == [False]
    assert sf.wire_diff(codes_a[0], codes_b[0], d) == {
        "scores": {"kept set": 1, "int8 code": 0}}
    assert sf.wire_diff(codes_a[0], codes_a[0], d) == {}
    # the int8 codes are the round trip's: decode(codes) == the round trip
    x = torch.randn(4, 64)
    k = wire.topk_k(64, cfg.topk_frac)
    dec = wire.encode_decode_stacked(x, cfg)
    scale = x.abs().amax(1, keepdim=True)
    np.testing.assert_array_equal(
        (wire.message_codes(x, cfg).float() * (scale / 127)).numpy(), dec.numpy())
    assert int((wire.message_codes(x, cfg) != 0).sum(1).max()) <= k


def test_engine_and_predict_record_the_same_wire_messages():
    """The engine's recorded codes (micro-batched, padded, a request
    chunked across batches) are predict's for each VFL request; the
    local routes record none."""
    spec = make_task("smnist")
    ecfg = EncoderConfig(d_hidden=16, n_layers=1)
    gen = torch.Generator().manual_seed(0)
    models = init_client_models(gen, spec, ecfg, device="cpu")
    gmv = fusion_init(gen, 16, spec.out_dim, device="cpu")
    rng = np.random.default_rng(1)
    reqs = []
    for n, vfl in ((3, True), (1, True), (11, True), (2, False), (5, True)):
        xa = rng.standard_normal((n, spec.seq_a, spec.feat_a)).astype(np.float32)
        xb = rng.standard_normal((n, spec.seq_b, spec.feat_b)).astype(np.float32)
        reqs.append(InferenceRequest(xa, xb, vfl=vfl))
    eng = ServingEngine(models, ecfg, spec.kind, server_gmv=gmv, device="cpu",
                        cfg=ServingConfig(capacities=(2, 4, 8), codec="int8_topk",
                                          record_wire=True))
    errs, flips = [], []
    for res, req in zip(eng.run(reqs), reqs):
        ref = predict(models, req, ecfg, spec.kind, server_gmv=gmv,
                      codec="int8_topk" if req.vfl else None, device="cpu",
                      record_wire=True)
        if not req.vfl:
            assert res.wire is None and ref.wire is None
            continue
        assert tuple(res.wire.shape) == (len(req.x_a), 2 * 16 + spec.out_dim)
        assert res.wire.shape == ref.wire.shape
        errs.append((res.scores - ref.scores).abs().numpy())
        flips.append(sf.message_flips(res.wire, ref.wire))
    tol = sf.within_tolerance(errs, lossy=True, flips=flips)
    assert tol.ok, tol
    plain = ServingEngine(models, ecfg, spec.kind, server_gmv=gmv, device="cpu",
                          cfg=ServingConfig(capacities=(2, 4, 8), codec="int8_topk"))
    assert all(r.wire is None for r in plain.run(reqs))


def test_stream_salt_fixes_the_stream():
    """A salt stands in for the per-process hash(mix): the stream is the
    same whatever the process, and differs between salts."""
    spec = make_task("smnist")

    def rows(reqs):
        return [(r.vfl, r.x_a if r.x_a is not None else r.x_b) for r in reqs]

    def same(a, b):
        return all(va == vb and xa.shape == xb.shape and np.array_equal(xa, xb)
                   for (va, xa), (vb, xb) in zip(a, b))

    a = rows(sf.make_requests(spec, "vfl_heavy", 6, rows=4, seed=0, salt=11))
    b = rows(sf.make_requests(spec, "vfl_heavy", 6, rows=4, seed=0, salt=11))
    c = rows(sf.make_requests(spec, "vfl_heavy", 6, rows=4, seed=0, salt=12))
    assert same(a, b) and not same(a, c)
