"""Parity of the port's ensemble generators with credit_tpu's: seeding
(utils/seed.py), the IC noise classes, bred vectors and the SDL inference
wrapper.

credit_tpu draws from jax.random keys, which no torch generator replays.
Every draw of the port's ensemble modules goes through one seam,
`credit_torch.ensemble.noise.normal`; the `replay` fixture replaces it with
a queue of credit_tpu's draws for the same key sequence, so both sides run
on the same numbers. The SDL wrapper's draws are read from credit_tpu's
forward (the latent intercepted on `noise_transform`, the pixels from its
`captured` collection) and handed to the port as the model's `noise=`.
Tolerances (f32): the noise given the draws 1e-6 of its largest value;
bred vectors and SDL outputs 1e-5 relative; SDL in bf16 3e-2 (both sides
round every layer's activations, in other orders).
"""

import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from credit_tpu.ensemble import bred_vector as jbred
from credit_tpu.ensemble import noise as jnoise
from credit_tpu.ensemble.sdl_wrapper import SDLInferenceWrapper as JWrapper
from credit_tpu.grid import Grid as JGrid
from credit_tpu.models import load_model as jax_load_model
from credit_tpu.utils import seed as jseed
from credit_torch.convert_jax import from_jax_variables
from credit_torch.ensemble import bred_vector, noise
from credit_torch.ensemble.sdl_wrapper import SDLInferenceWrapper
from credit_torch.grid import Grid
from credit_torch.models import load_model
from credit_torch.utils import seed
from tests.test_torch_port_ensemble import _numpy_variables
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

NOISE_TOL = 1e-6
TOL = 1e-5
BF16_TOL = 3e-2


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _rand(shape, s, scale=1.0):
    return (scale * np.random.default_rng(s).standard_normal(shape)).astype(np.float32)


@pytest.fixture
def replay(monkeypatch):
    """replay(draws): the port's draws come from `draws` (numpy or jax
    arrays) in order, each checked against the shape asked for; returns the
    queue, empty once every draw was used."""

    def install(draws):
        queue = [np.array(d, np.float32) for d in draws]

        def normal(generator, shape, dtype=torch.float32, device=None):
            d = queue.pop(0)
            assert tuple(d.shape) == tuple(shape), (d.shape, shape)
            return torch.from_numpy(d).to(device or "cpu", dtype)

        monkeypatch.setattr(noise, "normal", normal)
        return queue

    return install


# --------------------------------------------------------------- seed
def test_seed_everything_and_dtypes():
    """The host generators seeded as credit_tpu seeds them (python, numpy,
    PYTHONHASHSEED with the data rank), the root generator reproducible;
    parse_dtype maps credit_tpu's names to the same dtypes; fold_generator
    gives one stream per key sequence."""
    jseed.seed_everything(5, 2)
    want = (random.random(), np.random.rand())
    g = seed.seed_everything(5, 2)
    assert (random.random(), np.random.rand()) == want
    assert torch.equal(torch.randn(4, generator=g),
                       torch.randn(4, generator=seed.seed_everything(5, 2)))
    for name in ("float32", "fp32", "bfloat16", "bf16", "float16", "fp16", "float64", "BF16"):
        assert str(seed.parse_dtype(name)).split(".")[-1] == jnp.dtype(
            jseed.parse_dtype(name)).name
    assert seed.parse_dtype(torch.float16) is torch.float16
    a, b, c = (torch.randn(8, generator=seed.fold_generator(*k))
               for k in ((0, 4, 1), (0, 4, 1), (0, 4, 2)))
    assert torch.equal(a, b) and not torch.equal(a, c)


# --------------------------------------------------------------- noise
def test_gaussian_and_color_noise_match_reference(replay):
    x = _rand((2, 1, 8, 16, 5), 0)
    key = jax.random.PRNGKey(3)
    chol = np.tril(_rand((5, 5), 1)) + 2 * np.eye(5, dtype=np.float32)
    want = [np.asarray(jnoise.GaussianNoise(0.3)(key, jnp.asarray(x))),
            np.asarray(jnoise.ColorNoise(0.2, chol=chol)(key, jnp.asarray(x)))]
    draw = jax.random.normal(key, x.shape, jnp.float32)
    replay([draw, draw])
    got = [noise.GaussianNoise(0.3)(None, torch.from_numpy(x)),
           noise.ColorNoise(0.2, chol=chol)(None, torch.from_numpy(x))]
    for g, w in zip(got, want):
        _close(g, w, NOISE_TOL)


@pytest.mark.parametrize("lmax", [None, 9])
def test_spherical_noise_matches_reference(replay, lmax):
    """The real and imaginary normals of credit_tpu's split key replayed:
    the field and the noised state. As credit_tpu's, degree l's power
    scales coefficient row l - 1 (the mean mode is drawn; ROADMAP queue
    3, copied for parity)."""
    x = _rand((2, 1, 16, 32, 3), 2)
    key = jax.random.PRNGKey(4)
    jn = jnoise.SphericalNoise(JGrid.regular(16, 32), std=0.05, alpha=2.0, lmax=lmax)
    want = np.asarray(jn(key, jnp.asarray(x)))
    kr, ki = jax.random.split(key)
    shape = (2, 1, 3, jn.sht.lmax, jn.sht.mmax)
    draws = [jax.random.normal(kr, shape), jax.random.normal(ki, shape)]
    replay(draws * 2)
    tn = noise.SphericalNoise(Grid.regular(16, 32), std=0.05, alpha=2.0, lmax=lmax)
    _close(tn.field(None, (2, 1, 3)), jn.field(key, (2, 1, 3)), NOISE_TOL)
    got = tn(None, torch.from_numpy(x))
    _close(got, want, NOISE_TOL)
    np.testing.assert_allclose(tn.amp[:, 0].numpy(), np.asarray(jn.amp)[:, 0], rtol=1e-7)
    assert tn.amp[0, 0] == pytest.approx(2.0 ** -0.5)  # degree 1's on row 0
    assert abs(float((got - torch.from_numpy(x)).mean())) > 0  # the mean mode is drawn


def test_temporal_noise_and_rescale_match_reference(replay):
    """One innovation per frame from credit_tpu's split(key, t), the AR(1)
    recursion across frames, and the hemispheric rescale."""
    x = _rand((2, 4, 8, 16, 3), 3)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jnoise.TemporalNoise(0.1, rho=0.7)(key, jnp.asarray(x)))
    keys = jax.random.split(key, 4)
    replay([jax.random.normal(k, (2, 8, 16, 3)) for k in keys])
    got = noise.TemporalNoise(0.1, rho=0.7)(None, torch.from_numpy(x))
    _close(got, want, NOISE_TOL)
    lat = np.linspace(90, -90, 8)
    want = np.asarray(jnoise.hemispheric_rescale(jnp.asarray(x), lat, 2.0, 0.5, 0.1))
    np.testing.assert_array_equal(
        noise.hemispheric_rescale(torch.from_numpy(x), lat, 2.0, 0.5, 0.1).numpy(), want)


# --------------------------------------------------------------- bred vectors
def _steps(seed_):
    """The same nonlinear step on both sides: tanh of a channel mix plus a
    shift along longitude."""
    a = _rand((4, 4), seed_, 0.8)

    def jstep(x):
        return jnp.tanh(jnp.einsum("...i,ij->...j", x, a)) + 0.5 * jnp.roll(x, 1, axis=-2)

    def tstep(x):
        return torch.tanh(torch.einsum("...i,ij->...j", x, torch.from_numpy(a))) + \
            0.5 * torch.roll(x, 1, dims=-2)

    return jstep, tstep


@pytest.mark.parametrize("n_members", [1, 3, 4])
def test_bred_vectors_match_reference(replay, n_members):
    """generate_bred_vectors with credit_tpu's per-pair seed draws: the
    mirrored members x0 +- bv, each bred over 3 cycles with the RMS over the
    whole tensor; 1e-5 relative."""
    jstep, tstep = _steps(6)
    x0 = _rand((1, 1, 8, 16, 4), 7)
    key = jax.random.PRNGKey(8)
    want = jbred.generate_bred_vectors(jstep, jnp.asarray(x0), key, n_members, 0.05, 3)
    draws, k = [], key
    for _ in range((n_members + 1) // 2):
        k, sub = jax.random.split(k)
        draws.append(jax.random.normal(sub, x0.shape, jnp.float32))
    queue = replay(draws)
    got = bred_vector.generate_bred_vectors(tstep, torch.from_numpy(x0), None, n_members,
                                            0.05, 3)
    assert not queue and len(got) == len(want) == n_members
    for g, w in zip(got, want):
        _close(g - torch.from_numpy(x0), np.asarray(w) - x0, TOL)
    if n_members > 1:
        torch.testing.assert_close(got[1] - torch.from_numpy(x0),
                                   -(got[0] - torch.from_numpy(x0)), rtol=0, atol=1e-6)
        bv = (got[0] - torch.from_numpy(x0)).double()
        assert float(torch.sqrt(torch.mean(bv ** 2))) == pytest.approx(0.05, rel=1e-4)


# --------------------------------------------------------------- SDL wrapper
SDL_CONF = {"model": {
    "type": "crossformer-ensemble", "frames": 1, "output_frames": 1,
    "image_height": 32, "image_width": 64, "levels": 2, "channels": 2,
    "surface_channels": 1, "input_only_channels": 0, "output_only_channels": 0,
    "dim": [16, 32, 64, 128], "depth": [1, 1, 1, 1], "global_window_size": [2, 2, 2, 1],
    "local_window_size": 2, "dim_head": 8,
    "cross_embed_kernel_sizes": [[2, 4], [2, 2], [2, 2], [2, 2]],
    "cross_embed_strides": [2, 2, 2, 2], "use_spectral_norm": False, "interp": True,
    "noise_latent_dim": 16,
}}


def _jit_forward(jw):
    """credit_tpu's SDLInferenceWrapper.forward under jax.jit, the wrapper's
    variables (its noise factors) passed in: (capture, replay). Its eager
    flax apply takes ~15 s for this model on the CPU, jitted ~2.5 s.
    capture(variables, x, key) -> (y, the port's noise dict, credit_tpu's
    latents); replay(variables, x, latents) -> y."""

    def capture(variables, x, key):
        latent = []

        def intercept(next_fun, args, kwargs, ctx):
            if ctx.module.name == "noise_transform" and ctx.method_name == "__call__":
                latent.append(args[0])
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(intercept):
            y, lat = JWrapper.forward(SimpleNamespace(model=jw.model, variables=variables), x,
                                      key=key, capture=True)
        return y, latent[0], lat

    def replay(variables, x, latents):
        return JWrapper.forward(SimpleNamespace(model=jw.model, variables=variables), x,
                                latents=latents)

    cap, rep = jax.jit(capture), jax.jit(replay)

    def run_capture(x, key):
        y, latent, lat = cap(jw.variables, jnp.asarray(x), key)
        return y, _port_noise(latent, lat["latents"]), lat

    return run_capture, lambda x, latents: rep(jw.variables, jnp.asarray(x), latents)


def _port_noise(latent, pixels):
    out = {"latent": latent, **{k: v["pixel"] for k, v in pixels.items()}}
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


@pytest.fixture(scope="module")
def sdl():
    jmodel = jax_load_model(SDL_CONF)
    x = _rand((2, 1, 32, 64, 5), 9)
    variables = _numpy_variables(jmodel, np.zeros_like(x), 10)
    jw = JWrapper(jmodel, jax.tree_util.tree_map(jnp.asarray, variables))
    model = load_model(SDL_CONF, device="cpu")
    model.load_state_dict(from_jax_variables(variables, SDL_CONF, device="cpu"))
    capture, replay = _jit_forward(jw)
    return {"jw": jw, "tw": SDLInferenceWrapper(model), "x": x, "variables": variables,
            "capture": capture, "replay": replay}


def test_sdl_noise_factor_control_matches_reference(sdl):
    """Set all, encoder, decoder, manual large/medium/fine and reset on both
    wrappers: the same factors after each, and under the manual ones the
    forward with credit_tpu's draws within 1e-5."""
    jw, tw, x = sdl["jw"], sdl["tw"], sdl["x"]
    assert tw.layer_names() == jw.layer_names()
    for call, arg in [("set_noise_factors", 0.5), ("set_encoder_noise_factors", [0.1, 0.2, 0.3]),
                      ("set_decoder_noise_factors", 0.7), ("reset_to_original", None),
                      ("set_manual_factors", (1.0, 0.5, 0.25))]:
        for w in (jw, tw):
            args = () if arg is None else arg if isinstance(arg, tuple) else (arg,)
            getattr(w, call)(*args)
        got, want = tw.get_noise_factors(), jw.get_noise_factors()
        assert list(got) == list(want)
        np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-7)
    with pytest.raises(ValueError):
        tw.set_decoder_noise_factors([1.0, 2.0])
    y, draws, _ = sdl["capture"](x, jax.random.PRNGKey(3))
    _close(tw.forward(torch.from_numpy(x), latents=draws), y, TOL)
    jw.reset_to_original()
    tw.reset_to_original()
    assert tw.get_noise_factors() == pytest.approx(jw.get_noise_factors(), rel=1e-7)


def test_sdl_capture_replay_and_interpolation_match_reference(sdl):
    """credit_tpu's captures replayed in the port, and its interpolation at
    t = 0.3 against the port's of the same captures (pixels lerped, the
    first capture's latent kept, as credit_tpu keeps the first key)."""
    jw, tw, x = sdl["jw"], sdl["tw"], sdl["x"]
    ya, la, jwa = sdl["capture"](x, jax.random.PRNGKey(10))
    _, lb, jwb = sdl["capture"](x, jax.random.PRNGKey(11))
    jw.store_latents("a", jwa)
    jw.store_latents("b", jwb)
    _close(sdl["replay"](x, jw.get_stored_latents("a")), ya, TOL)
    want = sdl["replay"](x, jw.interpolate_latents("a", "b", 0.3))
    tw.store_latents("a", la)
    tw.store_latents("b", lb)
    assert tw.list_stored_latents() == jw.list_stored_latents() == ["a", "b"]
    _close(tw.forward(torch.from_numpy(x), latents=tw.get_stored_latents("a")), ya, TOL)
    _close(tw.forward(torch.from_numpy(x), latents=tw.interpolate_latents("a", "b", 0.3)),
           want, TOL)
    tw.clear_stored_latents("a")
    assert tw.list_stored_latents() == ["b"]
    tw.clear_stored_latents()
    assert tw.get_stored_latents("b") is None


def test_sdl_capture_is_the_replay(sdl):
    """The port's own capture: the draws a forward used, which replay it
    bit for bit; another generator differs; with every factor 0 two draws
    give the same output; interpolation at t = 0 is the first capture."""
    tw = sdl["tw"]
    x = torch.from_numpy(sdl["x"])
    y1, lat1 = tw.forward(x, generator=torch.Generator().manual_seed(1), capture=True)
    assert set(lat1) == {"latent", *tw.layer_names()}
    assert torch.equal(tw.forward(x, generator=torch.Generator().manual_seed(1)), y1)
    assert torch.equal(tw.forward(x, latents=lat1), y1)
    y2, lat2 = tw.forward(x, generator=torch.Generator().manual_seed(2), capture=True)
    assert (y1 - y2).abs().max() > 1e-3
    tw.store_latents("one", lat1)
    tw.store_latents("two", lat2)
    assert torch.equal(tw.forward(x, latents=tw.interpolate_latents("one", "two", 0.0)), y1)
    tw.set_noise_factors(0.0)
    try:
        assert torch.equal(tw.forward(x, latents=lat1), tw.forward(x, latents=lat2))
    finally:
        tw.reset_to_original()
    assert torch.equal(tw.forward(x), tw.forward(x, generator=torch.Generator().manual_seed(0)))


def test_sdl_bf16_forward_matches_reference(sdl):
    """bf16 compute on both sides (f32 weights), credit_tpu's draws replayed:
    within 3e-2 relative."""
    conf = {"model": {**SDL_CONF["model"], "compute_dtype": "bfloat16"}}
    jmodel = jax_load_model(conf)
    jw = JWrapper(jmodel, jax.tree_util.tree_map(jnp.asarray, sdl["variables"]))
    model = load_model(conf, device="cpu")
    model.load_state_dict(from_jax_variables(sdl["variables"], conf, device="cpu"))
    y, draws, _ = _jit_forward(jw)[0](sdl["x"], jax.random.PRNGKey(12))
    got = SDLInferenceWrapper(model).forward(torch.from_numpy(sdl["x"]), latents=draws)
    _close(got.float(), np.asarray(y, np.float32), BF16_TOL)
