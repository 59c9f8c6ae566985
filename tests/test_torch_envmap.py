"""Port distributions, lat-long lookup and envmap vs terra_tpu on
tests/test_envmap.py's open floor scene, with a numpy lat-long texture and
with a constant environment.

Tolerances. ``torch.cumsum`` and XLA's CPU cumulative sum add in another
order, so CDFs agree to rtol 1e-5, not bit for bit; from the same tables
(the reference's, handed to the port) the sampled indices are equal. From
each package's own tables a uniform within an ulp of a bucket edge may
land in the neighbouring bucket: at most 0.1% of lanes. ``torch.atan2`` /
``torch.acos`` and XLA's differ by an ulp, which can move a direction
exactly on a texel or proposal-grid edge: the same share.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from terra_tpu import envmap as jenv, textures as jtex
from terra_tpu.ops import distributions as jdist
from terra_tpu_torch import envmap as tenv, interop, textures as ttex
from terra_tpu_torch.ops import distributions as tdist
from tests.test_envmap import _env_scene
from tests.test_torch_bsdf import torch_one_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_scene import flatten

N = 1 << 14
RTOL = 1e-5
SHARE = 1e-3


def _t(x):
    """A torch copy of a numpy or JAX array."""
    return torch.tensor(np.array(x))


def _texture():
    tex = np.full((32, 64, 3), 0.05, np.float32)
    tex[8:12, 20:28] = 50.0
    tex[20:24, 40:50] = (0.3, 2.0, 5.0)
    return tex


@pytest.fixture(scope="module", params=["texture", "constant"])
def scenes(request):
    js = _env_scene(tex=_texture()) if request.param == "texture" else \
        _env_scene(const=(0.5, 0.6, 0.8))
    return js, interop.scene_from_numpy(flatten(js), device="cpu")


def _uniforms(seed, n=N):
    gen = np.random.default_rng(seed)
    return gen.random(n).astype(np.float32), gen.random(n).astype(np.float32)


def _dirs(seed, n=N):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _dist_to_torch(d):
    c, m = d.conditionals, d.marginal
    return tdist.Distribution2D(
        conditionals=tdist.Distribution1D(_t(c.f), _t(c.cdf), _t(c.integral)),
        marginal=tdist.Distribution1D(_t(m.f), _t(m.cdf), _t(m.integral)))


def test_build_matches_reference():
    f = np.random.default_rng(0).random((64, 128)).astype(np.float32)
    f[3] = 0.0  # an empty row
    j2, t2 = jdist.build_2d(jnp.array(f)), tdist.build_2d(_t(f))
    for a, b in ((t2.conditionals, j2.conditionals), (t2.marginal, j2.marginal)):
        for name in ("f", "cdf", "integral"):
            np.testing.assert_allclose(getattr(a, name).numpy(), np.asarray(getattr(b, name)),
                                       rtol=RTOL, atol=1e-7)


def test_sample_1d_matches_reference():
    f = np.random.default_rng(1).random(257).astype(np.float32)
    e, _ = _uniforms(2)
    jd = jdist.build_1d(jnp.array(f))
    td = tdist.Distribution1D(_t(jd.f), _t(jd.cdf), _t(jd.integral))
    jx, jp, ji = (np.asarray(v) for v in jdist.sample_1d(jd, jnp.array(e)))
    tx, tp, ti = tdist.sample_1d(td, _t(e))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=RTOL)
    # from the port's own tables
    ti2 = tdist.sample_1d(tdist.build_1d(_t(f)), _t(e))[2].numpy()
    assert (ti2 != ji).mean() <= SHARE


def test_sample_2d_matches_reference(scenes):
    js, ts = scenes
    jd = jenv.build_distribution(js)
    e1, e2 = _uniforms(3)
    (ju, jv), jp = jdist.sample_2d(jd, jnp.array(e1), jnp.array(e2))
    (tu, tv), tp = tdist.sample_2d(_dist_to_torch(jd), _t(e1), _t(e2))
    # the bucket of each sample, equal from the same tables
    np.testing.assert_array_equal(np.floor(tu.numpy() * 128), np.floor(np.asarray(ju) * 128))
    np.testing.assert_array_equal(np.floor(tv.numpy() * 64), np.floor(np.asarray(jv) * 64))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL)


def test_build_distribution_matches_reference(scenes):
    js, ts = scenes
    jd, td = jenv.build_distribution(js), tenv.build_distribution(ts)
    np.testing.assert_allclose(td.conditionals.f.numpy(), np.asarray(jd.conditionals.f),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(td.marginal.cdf.numpy(), np.asarray(jd.marginal.cdf),
                               rtol=1e-4, atol=1e-7)


def test_latlong_and_radiance_match_reference(scenes):
    js, ts = scenes
    d = _dirs(4)
    ref = np.asarray(jenv.radiance(js, jnp.array(d)))
    got = tenv.radiance(ts, _t(d)).numpy()
    off = np.abs(got - ref).max(axis=1) > 1e-5 * (1.0 + np.abs(ref).max(axis=1))
    assert off.mean() <= SHARE
    if int(js.env_tex) >= 0:
        tid = np.zeros(N, np.int32)
        jl = np.asarray(jtex.sample_latlong(js.textures, jnp.array(tid), jnp.array(d)))
        tl = ttex.sample_latlong(ts.textures, _t(tid), _t(d)).numpy()
        np.testing.assert_array_equal(tl, got)
        np.testing.assert_array_equal(jl, ref)
    assert np.isfinite(got).all() and got.mean() > 0.0


def test_env_sample_and_pdf_match_reference(scenes):
    js, ts = scenes
    jd = jenv.build_distribution(js)
    td = _dist_to_torch(jd)
    e1, e2 = _uniforms(5)
    jw, jp = (np.asarray(v) for v in jenv.sample(jd, jnp.array(e1), jnp.array(e2)))
    tw, tp = tenv.sample(td, _t(e1), _t(e2))
    np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-4)
    d = _dirs(6)
    jpdf = np.asarray(jenv.pdf(jd, jnp.array(d)))
    tpdf = tenv.pdf(td, _t(d)).numpy()
    off = ~np.isclose(tpdf, jpdf, rtol=1e-4)
    assert off.mean() <= SHARE
    # the port's own distribution gives its own sample() and pdf() the same
    # density (test_envmap.py's check), except for samples on a bucket edge,
    # whose direction pdf() may place in the neighbouring bucket
    own = tenv.build_distribution(ts)
    w, p = tenv.sample(own, _t(e1), _t(e2))
    off = ~np.isclose(tenv.pdf(own, w).numpy(), p.numpy(), rtol=2e-2, atol=1e-4)
    assert off.mean() <= SHARE
