"""Port of the offline VQ fitting (``core/vq.fit_vq``,
``quantize_params(method="fit")``) and the fitted KV codebooks
(``fit_kv_codebooks``, ``calibrate_kv_codebooks``), held against the JAX
reference. The two frameworks draw their k-means seeds differently, so a
fit is held by what does not depend on the draws:

  * the per-column ``scale`` bit-equal where the column means are exact
    (weights on a power-of-two grid), within fp32 reassociation of the
    column mean (2 ulp) on Gaussian weights;
  * the point layout: a weight whose normalized d-vectors take at most
    256 values is recovered exactly by both;
  * tree, shapes, dtypes and ``splits`` equal to the reference's, and
    every leaf's relative error at most 1.05x the reference's fit of the
    same weight;
  * a JAX-fitted model (and JAX-calibrated KV codebooks), converted,
    gives the JAX engine's greedy streams at fp32;
  * the k-means++ seed draw (C8): at or below ``MULTINOMIAL_MAX_POINTS``
    a set, bit for bit the ``torch.multinomial`` seeding it had before
    the inverse-CDF draw; above it (the cutoff lowered) the inverse-CDF
    draw's seeds are points of their set, never a zero-distance point
    while another is left, and proportional to the distances.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import quantize as jq
from repro.core import vq as jvq
from repro.models import build_model as jax_build_model
from repro.models.common import RunConfig as JaxRunConfig
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import quantize as tq
from repro_torch.core import vq as tvq
from repro_torch.models import RunConfig, build_model
from repro_torch.serve import Engine, EngineConfig

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ERR_RATIO = 1.05  # a port fit's error against the reference's fit


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grid_weight(rng, K, N):
    """(K, N) weights whose column-major d=8 vectors are sign patterns of
    {-1, 1}^8 (256 values, every one used) times a per-column power of
    two: the column means of W^2 are exact, so is the scale, and the
    normalized points take at most 256 values."""
    V = K // 8
    codes = rng.permutation(np.resize(np.arange(256), V * N)).reshape(V, N)
    bits = ((codes[..., None] >> np.arange(8)) & 1) * 2.0 - 1.0  # (V, N, 8)
    W = bits.transpose(0, 2, 1).reshape(K, N)
    col = 2.0 ** rng.integers(-2, 2, N)
    return (W * col[None, :]).astype(np.float32)


@pytest.mark.parametrize("K,N", [(64, 64), (128, 96)])
def test_grid_weight_recovered_exactly_with_bit_equal_scale(K, N):
    W = _grid_weight(np.random.default_rng(K + N), K, N)
    ref = jvq.fit_vq(KEY, jnp.asarray(W), kmeans_iters=5, refine_rounds=1)
    got = tvq.fit_vq(torch.Generator().manual_seed(0), torch.from_numpy(W),
                     kmeans_iters=5, refine_rounds=1)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(np.asarray(jvq.dequantize(ref)), W)
    np.testing.assert_array_equal(tvq.dequantize(got).numpy(), W)
    assert tvq.reconstruction_error(torch.from_numpy(W), got).item() == 0.0
    assert (got.idx.shape, got.idx.dtype, got.codebooks.shape) == (
        (2, K // 8, N), torch.uint8, (2, 8, 256))


def test_grouped_fit_records_splits_and_recovers():
    rng = np.random.default_rng(3)
    Ws = [_grid_weight(rng, 64, n) for n in (64, 32, 32)]
    ref = jvq.fit_vq(KEY, [jnp.asarray(w) for w in Ws], kmeans_iters=4,
                     refine_rounds=0)
    got = tvq.fit_vq(torch.Generator().manual_seed(0),
                     [torch.from_numpy(w) for w in Ws], kmeans_iters=4,
                     refine_rounds=0)
    assert got.splits == ref.splits == (64, 32, 32)
    assert (got.K, got.N) == (ref.K, ref.N) == (64, 128)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(tvq.dequantize(got).numpy(),
                                  np.concatenate(Ws, axis=1))
    with pytest.raises(ValueError, match="equal K"):
        tvq.fit_vq(torch.Generator(), [torch.zeros(64, 8), torch.zeros(72, 8)])
    with pytest.raises(ValueError, match="not divisible"):
        tvq.fit_vq(torch.Generator(), torch.zeros(60, 8))


@pytest.mark.parametrize("K,N,C,refine", [
    (64, 96, 2, 1), (128, 256, 2, 0), (256, 128, 1, 0), (96, 80, 3, 1),
])
def test_gaussian_fit_error_within_reference(K, N, C, refine):
    """The scale within 2 ulp (the column mean's summation order), the
    fits' error within ERR_RATIO of the reference's, both averaged over
    four seeds (a small shape's fit, a few points a centroid, moves by
    a few per cent from seed to seed), and ``reconstruction_error``
    equal to the reference's on one weight."""
    W = (np.random.default_rng(K * N + C).standard_normal((K, N)) * 0.05
         ).astype(np.float32)
    refs = [jvq.fit_vq(jax.random.PRNGKey(s), jnp.asarray(W), C=C,
                       kmeans_iters=8, refine_rounds=refine)
            for s in range(4)]
    gots = [tvq.fit_vq(torch.Generator().manual_seed(s), torch.from_numpy(W),
                       C=C, kmeans_iters=8, refine_rounds=refine)
            for s in range(4)]
    ref = refs[0]
    for got in gots:
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale),
                                   rtol=2.4e-7, atol=0)
    want = np.mean([float(jvq.reconstruction_error(jnp.asarray(W), r))
                    for r in refs])
    err = np.mean([tvq.reconstruction_error(torch.from_numpy(W), g).item()
                   for g in gots])
    assert 0.0 < err <= ERR_RATIO * want, (err, want)
    want = float(jvq.reconstruction_error(jnp.asarray(W), ref))
    conv = from_jax_params(_np(ref), device="cpu")
    np.testing.assert_allclose(
        tvq.reconstruction_error(torch.from_numpy(W), conv).item(), want,
        rtol=1e-5)
    assert gots[0].bits_per_weight == ref.bits_per_weight == C * 8 / 8


def test_assign_in_chunks_equals_one_table(monkeypatch):
    """The chunked assignment is the whole table's argmin, ties to the
    lowest id (duplicate centroids)."""
    g = torch.Generator().manual_seed(0)
    pts = torch.randn((1000, 8), generator=g)
    cents = torch.randn((16, 8), generator=g)
    cents[5] = cents[2]                       # a tie: id 2 wins
    pts[:10] = cents[2]
    whole = tvq._assign(pts, cents)
    monkeypatch.setattr(tvq, "_ASSIGN_TABLE_BYTES", 4 * 16 * 37)
    np.testing.assert_array_equal(tvq._assign(pts, cents).numpy(),
                                  whole.numpy())
    assert (whole[:10] == 2).all()
    ref = np.asarray(jvq._assign(jnp.asarray(pts.numpy()),
                                 jnp.asarray(cents.numpy())))
    np.testing.assert_array_equal(whole.numpy(), ref)


def _parent_seeds(generator, points, k):
    """k-means++ seeding as ``kmeans_batched`` drew it before the
    inverse-CDF draw existed: one ``torch.multinomial`` a centroid."""
    H, P, d = points.shape
    rows = torch.arange(H)
    first = points[rows, torch.randint(0, P, (H,), generator=generator)]
    cents = torch.zeros((H, k, d))
    cents[:, 0] = first
    dists = ((points - first[:, None]) ** 2).sum(dim=-1)
    for i in range(1, k):
        total = dists.sum(dim=-1, keepdim=True)
        probs = torch.where(total > 0, dists / total.clamp(min=1e-30),
                            torch.full_like(dists, 1.0 / P))
        nxt = points[rows, torch.multinomial(probs, 1,
                                             generator=generator)[:, 0]]
        cents[:, i] = nxt
        dists = torch.minimum(dists, ((points - nxt[:, None]) ** 2).sum(-1))
    return cents


def test_kmeans_seeds_below_the_cutoff_bit_equal_the_parents():
    """Every set at most ``MULTINOMIAL_MAX_POINTS`` points keeps its
    ``torch.multinomial`` draw: the seeds (``iters=0``) and a full fit
    equal the previous seeding's, bit for bit."""
    pts = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 500, 8)).astype(np.float32))
    seeds, _ = tvq.kmeans_batched(torch.Generator().manual_seed(5), pts, 16,
                                  iters=0)
    assert torch.equal(seeds, _parent_seeds(torch.Generator().manual_seed(5),
                                            pts, 16))
    gen = torch.Generator().manual_seed(6)
    want = tvq._update(pts, tvq._assign(pts, _parent_seeds(gen, pts, 16)),
                       16, gen)
    got, _ = tvq.kmeans_batched(torch.Generator().manual_seed(6), pts, 16,
                                iters=1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("chunk", [3, 1 << 22])
def test_kmeans_seeds_above_the_cutoff_by_inverse_cdf(monkeypatch, chunk):
    """With the cutoff lowered below P, the seeds come from the
    inverse-CDF draw (over chunks of 3 points and in one): every seed is
    a point of its own set, a set of exactly k distinct points (each
    repeated) gets each of them once (a zero-distance point is never
    drawn while another is left), and a set whose points are all equal
    takes the uniform fallback."""
    monkeypatch.setattr(tvq, "MULTINOMIAL_MAX_POINTS", 16)
    monkeypatch.setattr(tvq, "_CDF_CHUNK", chunk)
    rng = np.random.default_rng(4)
    k, P = 8, 40
    distinct = rng.standard_normal((k, 2)).astype(np.float32)
    sets = np.stack([rng.standard_normal((P, 2)).astype(np.float32),
                     distinct[rng.permutation(np.arange(P) % k)],
                     np.full((P, 2), 1.5, np.float32)])
    pts = torch.from_numpy(sets)
    calls = []
    draw = tvq._inverse_cdf_draw
    monkeypatch.setattr(tvq, "_inverse_cdf_draw",
                        lambda *a: calls.append(1) or draw(*a))
    seeds, _ = tvq.kmeans_batched(torch.Generator().manual_seed(0), pts, k,
                                  iters=0)
    assert len(calls) == k - 1
    for h in range(3):
        member = (seeds[h][:, None, :] == pts[h][None]).all(-1).any(-1)
        assert member.all(), h
    assert len({tuple(r) for r in seeds[0].tolist()}) == k
    assert sorted(map(tuple, seeds[1].tolist())) == sorted(
        map(tuple, distinct.tolist()))
    assert (seeds[2] == 1.5).all()


def test_inverse_cdf_draw_frequencies(monkeypatch):
    """Draws proportional to the distances across chunk boundaries, never
    a zero-distance point; the all-zero set uniform."""
    monkeypatch.setattr(tvq, "_CDF_CHUNK", 2)
    d = torch.tensor([[0.0, 1.0, 3.0, 0.0, 4.0], [0.0] * 5])
    gen = torch.Generator().manual_seed(0)
    picks = torch.stack([tvq._inverse_cdf_draw(d, gen) for _ in range(4000)])
    freq = torch.bincount(picks[:, 0], minlength=5).double() / 4000
    np.testing.assert_allclose(freq.numpy(), [0, 0.125, 0.375, 0, 0.5],
                               atol=0.03)
    assert freq[0] == 0 and freq[3] == 0
    uni = torch.bincount(picks[:, 1], minlength=5).double() / 4000
    np.testing.assert_allclose(uni.numpy(), [0.2] * 5, atol=0.03)


def test_kmeans_batched_recovers_each_heads_points():
    """Each head's points take at most k values (multiples of 1/8, so a
    cluster's mean is exact): every head's centroids reproduce its points
    exactly."""
    rng = np.random.default_rng(0)
    H, P, k = 3, 400, 16
    vals = (rng.integers(-16, 17, (H, k, 2)) / 8).astype(np.float32)
    pick = rng.integers(0, k, (H, P))
    pts = torch.from_numpy(vals[np.arange(H)[:, None], pick])
    cents, assign = tvq.kmeans_batched(torch.Generator().manual_seed(0), pts,
                                       k, iters=3)
    assert cents.shape == (H, k, 2) and assign.dtype == torch.int32
    rebuilt = cents[torch.arange(H)[:, None], assign.long()]
    np.testing.assert_array_equal(rebuilt.numpy(), pts.numpy())


@pytest.fixture(scope="module")
def smoke_fit():
    """llama2 SMOKE dense params, fitted by both packages (10 Lloyd
    iterations, no refinement: ``quantize_params``' settings)."""
    jcfg = dataclasses.replace(jax_smoke_config("llama2_7b"), dtype="float32")
    jm = jax_build_model(jcfg)
    dense = jm.init(KEY)
    ref = jm.quantize(dense, method="fit", key=KEY)
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), dtype="float32")
    tdense = from_jax_params(_np(dense), device="cpu")
    mine = build_model(cfg).quantize(
        tdense, generator=torch.Generator().manual_seed(0), device="cpu")
    return {"jm": jm, "cfg": cfg, "dense": tdense, "ref": ref,
            "mine": mine, "ref_conv": from_jax_params(_np(ref), device="cpu")}


def _leaves(params):
    """path -> VQWeight of a port tree (layers listed)."""
    out = {}

    def walk(node, path):
        if isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        elif isinstance(node, dict):
            if "vq" in node:
                out[path] = node["vq"]
                return
            for k, v in node.items():
                walk(v, path + (k,))

    walk(params, ())
    return out


_MEMBERS = {"wqkv": ("wq", "wk", "wv"), "gu": ("gate", "up")}


def _dense_of(dense, path):
    node = dense
    for p in path[:-1]:
        node = node[p]
    members = _MEMBERS.get(path[-1], (path[-1],))
    return torch.cat([node[m]["w"] for m in members], dim=-1)


def test_quantize_fit_tree_equals_reference(smoke_fit):
    mine, conv = _leaves(smoke_fit["mine"]), _leaves(smoke_fit["ref_conv"])
    assert set(mine) == set(conv) and len(mine) == 8
    for path, vq in mine.items():
        want = conv[path]
        assert (vq.K, vq.N, vq.d, vq.n, vq.splits) == (
            want.K, want.N, want.d, want.n, want.splits), path
        for name in ("idx", "codebooks", "scale"):
            a, b = getattr(vq, name), getattr(want, name)
            assert (a.shape, a.dtype) == (b.shape, b.dtype), (path, name)
    for name in ("embedding", "lm_head", "final_norm"):
        a = next(iter(smoke_fit["mine"][name].values()))
        b = next(iter(smoke_fit["ref_conv"][name].values()))
        assert (a.shape, a.dtype) == (b.shape, b.dtype)


def test_quantize_fit_errors_within_reference(smoke_fit):
    mine, conv = _leaves(smoke_fit["mine"]), _leaves(smoke_fit["ref_conv"])
    for path, vq in mine.items():
        W = _dense_of(smoke_fit["dense"], path)
        np.testing.assert_allclose(vq.scale.numpy(), conv[path].scale.numpy(),
                                   rtol=2.4e-7, atol=0)
        err = tvq.reconstruction_error(W, vq).item()
        want = tvq.reconstruction_error(W, conv[path]).item()
        assert err <= ERR_RATIO * want, (path, err, want)


def test_quantize_fit_experts_one_fit_a_weight():
    """A MoE site's stacked experts: one fit each, stacked on E."""
    cfg = dataclasses.replace(get_smoke_config("mixtral_8x22b"),
                              dtype="float32")
    m = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    dense = m.init(gen, device="cpu")
    layer = {"layers": [{"moe": dense["layers"][0]["moe"]}]}
    got = tq.quantize_params(layer, cfg, generator=gen, device="cpu")
    jlayer = {"layers": {"moe": jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy())[None], layer["layers"][0]["moe"])}}
    want = jq.quantize_params(jlayer, jax_smoke_config("mixtral_8x22b"),
                              method="fit", key=KEY)
    experts = got["layers"][0]["moe"]["experts"]
    jexp = want["layers"]["moe"]["experts"]
    for name in ("gu", "down"):
        vq, jv = experts[name]["vq"], jexp[name]["vq"]
        assert vq.idx.shape == jv.idx.shape[1:] and vq.splits == jv.splits
        W = (torch.cat([dense["layers"][0]["moe"]["experts"][m]["w"]
                        for m in _MEMBERS.get(name, (name,))], dim=-1))
        for e in range(vq.lead):
            err = tvq.reconstruction_error(W[e], tvq.vq_index(vq, e)).item()
            ref_e = from_jax_params(_np(jax.tree_util.tree_map(
                lambda a: a[0, e], jv)), device="cpu")
            assert err <= ERR_RATIO * tvq.reconstruction_error(
                W[e], ref_e).item(), (name, e)


def test_specs_method_lays_out_meta_tensors(smoke_fit):
    specs = tq.quantize_params(smoke_fit["dense"], smoke_fit["cfg"],
                               method="specs")
    mine = _leaves(smoke_fit["mine"])
    for path, vq in _leaves(specs).items():
        for name in ("idx", "codebooks", "scale"):
            t = getattr(vq, name)
            assert t.is_meta and t.shape == getattr(mine[path], name).shape
            assert t.dtype == getattr(mine[path], name).dtype
        assert vq.splits == mine[path].splits
    assert specs["embedding"]["emb"].is_meta
    with pytest.raises(ValueError, match="unknown method"):
        tq.quantize_params(smoke_fit["dense"], smoke_fit["cfg"],
                           method="kmeans")


def test_jax_fitted_model_serves_the_jax_engines_stream(smoke_fit):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, smoke_fit["cfg"].vocab_size, n
                            ).astype(np.int32) for n in (5, 9, 7)]
    want = JaxEngine(smoke_fit["jm"], smoke_fit["ref"],
                     JaxRunConfig(mode="decode", remat=False, attn_chunk=16),
                     JaxEngineConfig(num_slots=2, max_len=32)
                     ).generate(prompts, 6)
    got = Engine(build_model(smoke_fit["cfg"]), smoke_fit["ref_conv"],
                 RunConfig(attn_chunk=16),
                 EngineConfig(num_slots=2, max_len=32),
                 device="cpu").generate(prompts, 6)
    assert got == want


# ------------------------------------------------------------- KV codebooks


def _kv_error(x, cb, variant="outlier"):
    idx, s = tvq.kv_encode(x, cb, variant)
    return (torch.linalg.norm(tvq.kv_decode(idx, s, cb) - x)
            / torch.linalg.norm(x)).item()


@pytest.mark.parametrize("kv_bits,residual,variant", [
    (4, 1, "outlier"), (2, 1, "rms"), (4, 2, "outlier"),
])
def test_fit_kv_codebooks_error_within_reference(kv_bits, residual, variant):
    x = (np.random.default_rng(kv_bits + residual).standard_normal(
        (96, 3, 32)) * 1.5).astype(np.float32)
    ref_cfg = jvq.KVQuantConfig(kv_bits=kv_bits, residual=residual,
                                variant=variant)
    cfg = tvq.KVQuantConfig(kv_bits=kv_bits, residual=residual,
                            variant=variant)
    want = np.asarray(jvq.fit_kv_codebooks(KEY, jnp.asarray(x), ref_cfg,
                                           kmeans_iters=6))
    got = tvq.fit_kv_codebooks(torch.Generator().manual_seed(0),
                               torch.from_numpy(x), cfg, kmeans_iters=6)
    assert got.shape == want.shape == (3, residual, 256, cfg.vec_d)
    assert got.dtype == torch.float32
    xt = torch.from_numpy(x)
    assert _kv_error(xt, got, variant) <= ERR_RATIO * _kv_error(
        xt, torch.from_numpy(want.copy()), variant)


def test_fit_kv_codebooks_recovers_few_distinct_groups():
    """Each head's normalized groups take at most 256 values, multiples
    of 1/8 (the outlier scale is 1 on every row, a cluster's mean is
    exact): both fits encode them exactly."""
    rng = np.random.default_rng(1)
    vals = (rng.integers(-8, 9, (2, 40, 2)) / 8).astype(np.float32)
    vals[:, 0] = 1.0                          # every row's absmax is 1
    pick = rng.integers(1, 40, (64, 2, 8))
    pick[:, :, 0] = 0
    x = vals[np.arange(2)[None, :, None], pick].reshape(64, 2, 16)
    cfg = tvq.KVQuantConfig(kv_bits=4)
    got = tvq.fit_kv_codebooks(torch.Generator().manual_seed(0),
                               torch.from_numpy(x), cfg, kmeans_iters=4)
    want = jvq.fit_kv_codebooks(KEY, jnp.asarray(x), jvq.KVQuantConfig(
        kv_bits=4), kmeans_iters=4)
    xt = torch.from_numpy(x)
    assert _kv_error(xt, got) == 0.0
    assert _kv_error(xt, torch.from_numpy(np.array(want))) == 0.0


@pytest.fixture(scope="module")
def calibrated(smoke_fit):
    kvq = tvq.KVQuantConfig(kv_bits=4)
    toks = np.random.default_rng(2).integers(
        0, smoke_fit["cfg"].vocab_size, (2, 16)).astype(np.int32)
    ref = jq.calibrate_kv_codebooks(smoke_fit["jm"], smoke_fit["ref"],
                                    {"tokens": jnp.asarray(toks)},
                                    jvq.KVQuantConfig(kv_bits=4))
    mine = tq.calibrate_kv_codebooks(
        build_model(smoke_fit["cfg"]), smoke_fit["ref_conv"],
        {"tokens": torch.from_numpy(toks)}, kvq,
        generator=torch.Generator().manual_seed(0))
    return {"kvq": kvq, "toks": toks, "ref": ref, "mine": mine}


def test_calibrated_tree_and_errors_equal_reference(smoke_fit, calibrated):
    ref, mine = calibrated["ref"], calibrated["mine"]
    assert set(mine) == set(ref) == {"body"}
    assert set(mine["body"]) == set(ref["body"]) == {"k", "v"}
    m = build_model(smoke_fit["cfg"])
    with torch.no_grad():
        _, cache = m.prefill(smoke_fit["ref_conv"],
                             {"tokens": torch.from_numpy(calibrated["toks"])},
                             RunConfig(attn_chunk=16))
    for n in ("k", "v"):
        assert tuple(mine["body"][n].shape) == ref["body"][n].shape
        want = torch.from_numpy(np.asarray(ref["body"][n]))
        for layer in range(want.shape[0]):
            x = cache["body"][n][layer].reshape(
                -1, *cache["body"][n].shape[-2:])
            assert _kv_error(x, mine["body"][n][layer]) <= ERR_RATIO * \
                _kv_error(x, want[layer]), (n, layer)


def test_calibrated_codebooks_serve_the_jax_engines_stream(smoke_fit,
                                                          calibrated):
    """The reference's calibrated tree attached on both sides: every
    reader takes its layer's codebooks (decode encode, attention, the
    prefill encode), contiguous and paged."""
    cfg = smoke_fit["cfg"]
    jkvq = jvq.KVQuantConfig(kv_bits=4)
    jparams = jq.attach_kv_codebooks(smoke_fit["ref"], smoke_fit["jm"].cfg,
                                     jkvq, codebooks=calibrated["ref"])
    tree = {s: {n: torch.from_numpy(np.array(a)) for n, a in node.items()}
            for s, node in calibrated["ref"].items()}
    params = tq.attach_kv_codebooks(smoke_fit["ref_conv"], cfg,
                                    calibrated["kvq"], codebooks=tree)
    for layer in range(cfg.num_layers):
        got = params["layers"][layer]["attn"]["kv_cb"]["k"]
        np.testing.assert_array_equal(got.numpy(),
                                      tree["body"]["k"][layer].numpy())
    stacked = tq.kv_codebook_tree(params)
    np.testing.assert_array_equal(stacked["body"]["v"].numpy(),
                                  tree["body"]["v"].numpy())
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 7, 4)]
    want = JaxEngine(smoke_fit["jm"], jparams,
                     JaxRunConfig(mode="decode", remat=False, attn_chunk=16),
                     JaxEngineConfig(num_slots=2, max_len=32, kv_bits=4)
                     ).generate(prompts, 6)
    for paged in (False, True):
        extra = dict(paged=True, block_size=4) if paged else {}
        got = Engine(build_model(cfg), params, RunConfig(attn_chunk=16),
                     EngineConfig(num_slots=2, max_len=32, kv_bits=4,
                                  **extra), device="cpu").generate(prompts, 6)
        assert got == want, paged


def test_attach_without_a_segment_keeps_the_grid(smoke_fit, calibrated):
    only_pre = {"pre": calibrated["mine"]["body"]}
    params = tq.attach_kv_codebooks(smoke_fit["ref_conv"], smoke_fit["cfg"],
                                    calibrated["kvq"], codebooks=only_pre)
    grid = tvq.kv_grid_codebooks(smoke_fit["cfg"].num_kv_heads,
                                 smoke_fit["cfg"].head_dim, calibrated["kvq"])
    for lp in params["layers"]:
        np.testing.assert_array_equal(lp["attn"]["kv_cb"]["k"].numpy(),
                                      grid.numpy())
