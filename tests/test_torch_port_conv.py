"""What the conv wrappers (credit_torch/ops/cuda_conv.py) decide in Python
for the bf16 TMA/wgmma kernels, checked on the CPU, and the kernels on a
card.

`conv_plan` and `wgrad_plan` pick what each launch is told (tile widths,
BN, splits, the f32 tap group) and the workspace, and the wrappers zero-pad
channels that are not multiples of 8 (bf16) or 4 (f32). On the CPU: the
plans at the main paths' shapes, the plain versions on the padded channels,
cut back, against the unpadded ones and credit_tpu's Pallas kernels run
interpreted, and the f32 kernels' 3xTF32 arithmetic (the weight split, and
an emulation of the three products against f64 sums).
The kernels themselves run only on a card (the `cuda` tests here, which
import no flax model, and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from credit_tpu.ops import pallas_conv as jpc
from credit_torch.ops import cuda_conv
from credit_torch.ops.cuda_conv import conv_plan, wgrad_plan
from torch_port_fixtures import two_torch_threads  # noqa: F401 (an autouse fixture)

BF16 = torch.bfloat16


def _cdiv(a, b):
    return -(-a // b)


def _inputs(shape, seed, wgrad=False):
    """bf16-representable f32 values (numpy) of x and the kernel or gy."""
    n, hp, wp, cin, kh, kw, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hp, wp, cin)) * 0.5
    other = (rng.standard_normal((n, hp - kh + 1, wp - kw + 1, cout)) * 0.3 if wgrad
             else rng.standard_normal((kh, kw, cin, cout)) / np.sqrt(kh * kw * cin))
    to = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    return to(x), to(other)


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


CASES = [
    (1, 14, 21, 20, 3, 3, 12),      # channels not multiples of 8: padded
    (2, 12, 19, 48, 2, 2, 200),     # stage embeds' 2x2 after space-to-depth, ragged N tile
    (1, 20, 30, 72, 3, 2, 64),      # kh != kw, two K chunks
    (1, 4, 70, 64, 3, 3, 136),      # wide, flat output: 64-column tiles
    (1, 24, 27, 24, 8, 8, 40),      # the stage-0 embed's 8x8
    (1, 22, 22, 8, 16, 16, 16),     # beyond 8x8 taps: one kernel, one K loop
]


def _padded_channels(x: torch.Tensor, other: torch.Tensor, plan, wgrad=False):
    """x and the kernel (or gy) with the wrapper's channel padding."""
    x = cuda_conv._pad_last(x, plan.cin)
    other = (cuda_conv._pad_last(other, plan.cout) if wgrad
             else cuda_conv._pad_last2(other, plan.cin, plan.cout))
    return x, other


@pytest.mark.parametrize("shape", CASES)
def test_conv_padded_plain_matches_plain_and_pallas(shape):
    """The plain conv on the channels the bf16 plan pads to, cut back, is
    the unpadded conv and credit_tpu's Pallas kernel (interpreted)."""
    n, hp, wp, cin, kh, kw, cout = shape
    x, k = (torch.from_numpy(a) for a in _inputs(shape, seed=sum(shape)))
    plan = conv_plan(BF16, n, hp, wp, cin, kh, kw, cout)
    out = cuda_conv.conv2d_valid_plain(*_padded_channels(x, k, plan))[..., :cout]
    assert out.shape == (n, hp - kh + 1, wp - kw + 1, cout)
    # the same f32 sums (zeros add nothing), perhaps blocked otherwise
    assert _rel(out, cuda_conv.conv2d_valid_plain(x, k)) < 1e-6
    # against the Pallas kernel (interpreted) in bf16: one rounding of the
    # f32 sum, which a different order can flip by a bf16 ulp
    ref = jpc.conv2d_valid(jnp.asarray(x.numpy(), jnp.bfloat16), jnp.asarray(k.numpy(), jnp.bfloat16))
    assert _rel(out.to(BF16).float(), np.asarray(ref.astype(jnp.float32))) < 1e-2


@pytest.mark.parametrize("shape", CASES)
def test_wgrad_padded_plain_matches_plain_and_pallas(shape):
    """The plain weight gradient on the padded channels, cut back, is the
    unpadded one and credit_tpu's Pallas kernel's (interpreted)."""
    n, hp, wp, cin, kh, kw, cout = shape
    x, gy = (torch.from_numpy(a) for a in _inputs(shape, seed=sum(shape) + 1, wgrad=True))
    plan = wgrad_plan(BF16, n, hp, wp, cin, kh, kw, cout)
    out = cuda_conv.conv2d_wgrad_plain(*_padded_channels(x, gy, plan, wgrad=True), kh, kw)
    out = out[:, :, :cin, :cout]
    ref = cuda_conv.conv2d_wgrad_plain(x, gy, kh, kw)
    assert _rel(out, ref) < 1e-6  # the same f32 sums; zeros add nothing
    jref = jpc.conv2d_wgrad(jnp.asarray(x.numpy(), jnp.bfloat16),
                            jnp.asarray(gy.numpy(), jnp.bfloat16), kh, kw)
    assert _rel(out, np.asarray(jref, np.float32)) < 1e-5


def test_wgrad_plan_splits_leave_no_split_empty():
    """A case the plan splits: its workspace holds one f32 partial of the
    whole gradient a split, and no split is left empty (each of the
    ceil(chunks / splits) K-step shares the entry derives is non-empty)."""
    shape = (1, 40, 52, 16, 2, 2, 16)
    plan = wgrad_plan(BF16, *shape)
    assert plan.splits > 1 and plan.workspace == plan.splits * 2 * 2 * 16 * 16 * 4
    ho, wo = 40 - 1, 52 - 1
    chunks = _cdiv(wo, plan.sw) * _cdiv(ho, 64 // plan.sw)
    per = _cdiv(chunks, plan.splits)
    assert (plan.splits - 1) * per < chunks <= plan.splits * per


# the plans of the main paths' shapes (n, hp, wp, cin, kh, kw, cout), as
# measured on the card: (BN, TW) of the conv, (BN, SW, splits) of the
# weight gradient
MAIN_PATH_PLANS = [
    ((1, 415, 735, 240, 8, 8, 176), (192, 16), (192, 32, 1)),
    ((1, 402, 722, 256, 3, 3, 224), (256, 16), (256, 16, 22)),
    ((1, 201, 361, 512, 2, 2, 256), (256, 16), (256, 16, 8)),
    ((1, 51, 91, 2048, 2, 2, 1024), (192, 32), (256, 32, 1)),
    ((1, 102, 162, 1024, 3, 3, 1024), (256, 32), (256, 32, 3)),
    ((1, 101, 161, 4096, 2, 2, 1024), (256, 32), (256, 32, 1)),
]


@pytest.mark.parametrize("shape,conv,wgrad", MAIN_PATH_PLANS)
def test_plans_at_main_path_shapes(shape, conv, wgrad):
    n, hp, wp, cin, kh, kw, cout = shape
    cp = conv_plan(BF16, *shape)
    assert (cp.bn, cp.tw) == conv
    wp_ = wgrad_plan(BF16, *shape)
    assert (wp_.bn, wp_.sw, wp_.splits, wp_.group) == wgrad + ((1, 1),)
    assert wp_.workspace == (wp_.splits * kh * kw * cin * cout * 4 if wp_.splits > 1 else 0)


@pytest.mark.parametrize("cin,cout", [(8, 8), (20, 12), (100, 60), (240, 176), (1, 3)])
def test_plans_pad_channels_to_multiples_of_8(cin, cout):
    for plan in (conv_plan(BF16, 1, 9, 9, cin, 3, 3, cout),
                 wgrad_plan(BF16, 1, 9, 9, cin, 3, 3, cout)):
        assert plan.cin % 8 == 0 and plan.cout % 8 == 0
        assert plan.cin - cin < 8 and plan.cout - cout < 8
        assert plan.bn in cuda_conv.BN_CHOICES
    # f32 pads Cin to a multiple of 4 (TMA's 16 bytes); the conv's Cout
    # stays as it is (TMA zero-fills B's rows past it), the weight
    # gradient's goes to a multiple of 4 (its 16-byte copies of gy)
    f32 = conv_plan(torch.float32, 1, 9, 9, cin, 3, 3, cout)
    assert (f32.cin, f32.cout) == (cuda_conv._up(cin, 4), cout)
    assert f32.bn in cuda_conv.F32_BN_CHOICES
    f32w = wgrad_plan(torch.float32, 1, 9, 9, cin, 3, 3, cout)
    assert (f32w.cin, f32w.cout) == (cuda_conv._up(cin, 4), cuda_conv._up(cout, 4))


def test_f32_wgrad_plan_keeps_its_split_rule():
    """f32: 64 input channels by the cheapest BN of 16-64, a row of the
    fewest even groups of at most 4 taps, about 4 waves of two blocks per
    SM, at least 8 row segments of 32 pixels a split, none left empty."""
    p = wgrad_plan(torch.float32, 1, 415, 735, 240, 8, 8, 176)
    tiles = 4 * 3 * 2 * 8  # Cin tiles x Cout tiles of 64 x column groups of 4 x rows
    assert p.bn == 64 and p.group == (1, 4) and p.splits == _cdiv(8 * cuda_conv.SMS, tiles)
    assert [wgrad_plan(torch.float32, 1, 20, 20, 8, kh, kw, 8).group
            for kh, kw in [(2, 2), (2, 1), (3, 3), (3, 2), (1, 5), (8, 8), (16, 16)]] == [
        (1, 2), (1, 1), (1, 3), (1, 2), (1, 3), (1, 4), (1, 4)]
    assert p.workspace == p.splits * 8 * 8 * 240 * 176 * 4
    tiny = wgrad_plan(torch.float32, 1, 5, 5, 8, 3, 3, 8)
    assert tiny.splits == 1 and tiny.workspace == 0


# (cin, cout) -> the f32 N tile of the conv and of the weight gradient:
# SKEBS's cnn 60 -> 13, its input gradient 13 -> 60, the U-Net's 64 -> 64
# and 128 -> 64, the stage-0 embed's 240 -> 176, a U-Net level 3's 512
F32_TILES = [((60, 13), 16, 16), ((13, 60), 64, 64), ((64, 64), 64, 64), ((128, 64), 64, 64),
             ((240, 176), 128, 64), ((512, 512), 128, 64)]


@pytest.mark.parametrize("channels,conv_bn,wgrad_bn", F32_TILES)
def test_f32_plans_pick_the_n_tile_that_fits_cout(channels, conv_bn, wgrad_bn):
    """The f32 N tile pads Cout least where a wider one costs no fewer
    waves (13 -> 16, 60 -> 64, 64 -> 64); Cin padded to a multiple of 4."""
    cin, cout = channels
    shape = (2, 723, 1442, cin, 3, 3, cout)
    cp, wp_ = conv_plan(torch.float32, *shape), wgrad_plan(torch.float32, *shape)
    assert (cp.bn, wp_.bn) == (conv_bn, wgrad_bn)
    assert cp.cin == wp_.cin == cuda_conv._up(cin, 4) and cp.cin - cin < 4
    assert cp.tw == conv_plan(BF16, *shape).tw  # the same pixel tile as bf16


def _tf32_bits_zero(t: torch.Tensor) -> bool:
    return not (t.view(torch.int32) & ((1 << 13) - 1)).any()


@pytest.mark.parametrize("shape", [(3, 3, 60, 13), (2, 2, 17, 8), (1, 5, 4, 3)])
def test_tf32_split_and_k_major_weights(shape):
    """hi + lo gives back w within 2^-21 of |w|, each part tf32 (the low 13
    mantissa bits zero), hi rounded to nearest; laid out (taps, Cout, Cin),
    Cin zero-padded to a multiple of 4."""
    kh, kw, cin, cout = shape
    rng = np.random.default_rng(sum(shape))
    w = torch.from_numpy((rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 3, shape))
                         .astype(np.float32))
    hi, lo = cuda_conv.tf32_split(w)
    assert _tf32_bits_zero(hi) and _tf32_bits_zero(lo)
    wd = w.double()
    assert ((hi.double() - wd).abs() <= wd.abs() * 2.0 ** -11).all()
    assert ((hi.double() + lo.double() - wd).abs() <= wd.abs() * 2.0 ** -21).all()
    cp = cuda_conv._up(cin, 4)
    khi, klo = cuda_conv.tf32_weights(w, cp)
    assert khi.shape == klo.shape == (kh * kw, cout, cp) and khi.is_contiguous()
    assert torch.equal(khi[:, :, :cin], hi.reshape(kh * kw, cin, cout).transpose(1, 2))
    assert torch.equal(klo[:, :, :cin], lo.reshape(kh * kw, cin, cout).transpose(1, 2))
    assert not khi[:, :, cin:].any() and not klo[:, :, cin:].any()


def _emulated_tf32_conv(x: torch.Tensor, k: torch.Tensor, products: int) -> torch.Tensor:
    """The f32 conv as the tensor cores compute it: tf32 operands (rounded
    by bit masking), exact products summed in f32; 3xTF32's three products,
    or 1xTF32's one (plain TF32)."""
    (xh, xl), (kh_, kl) = cuda_conv.tf32_split(x), cuda_conv.tf32_split(k)
    terms = [(xl, kh_), (xh, kl), (xh, kh_)] if products == 3 else [(xh, kh_)]
    out = torch.zeros(1)
    for a, b in terms:
        out = out + cuda_conv.conv2d_valid_plain(a, b)
    return out


@pytest.mark.parametrize("shape", [(1, 20, 22, 60, 3, 3, 13), (1, 18, 18, 64, 3, 3, 64)])
def test_3xtf32_keeps_f32_accuracy_and_1xtf32_does_not(shape):
    """Against f64 sums, the 3xTF32 emulation stays within phase 2's f32
    limit (1e-5 of max |f64|, up to 15,360 products a sum); plain TF32's
    one product misses it by more than an order of magnitude: why the f32
    kernels split both operands."""
    n, hp, wp, cin, kh, kw, cout = shape
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((n, hp, wp, cin)) * 0.5).astype(np.float32))
    k = torch.from_numpy((rng.standard_normal((kh, kw, cin, cout)) / np.sqrt(kh * kw * cin))
                         .astype(np.float32))
    exact = cuda_conv.conv2d_valid_plain(x.double(), k.double())
    scale = float(exact.abs().max())
    tol = 1e-5 * max(1.0, kh * kw * cin / 15360) ** 0.5

    def err(out):
        return float((out.double() - exact).abs().max()) / scale

    assert err(_emulated_tf32_conv(x, k, 3)) < tol
    assert err(_emulated_tf32_conv(x, k, 1)) > 10 * tol


@pytest.mark.parametrize("shape", [(1, 66, 66, 60, 3, 3, 13), (2, 34, 34, 64, 3, 3, 64)])
def test_weight_gradient_f64_check_tells_3xtf32_from_tf32(shape):
    """The weight gradient emulated as the tensor cores compute it: 3xTF32
    stays within chip_smoke's f64 check (phase 2's f32 limit at n*ho*wo
    products a sum); plain TF32 misses it by more than an order of
    magnitude, yet stays within the 5e-4 of max |plain| that phase 2 holds
    #5 to against its plain version, so only the f64 check sees it."""
    import chip_smoke

    n, hp, wp, cin, kh, kw, cout = shape
    ho, wo = hp - kh + 1, wp - kw + 1
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((n, hp, wp, cin)) * 0.5).astype(np.float32))
    gy = torch.from_numpy((rng.standard_normal((n, ho, wo, cout)) * 0.1).astype(np.float32))
    (xh, xl), (gh, gl) = cuda_conv.tf32_split(x), cuda_conv.tf32_split(gy)

    def emulated(terms):
        return sum(cuda_conv.conv2d_wgrad_plain(a, b, kh, kw) for a, b in terms)

    exact = cuda_conv.conv2d_wgrad_plain(x.double(), gy.double(), kh, kw)
    plain = cuda_conv.conv2d_wgrad_plain(x, gy, kh, kw)
    limit = chip_smoke.f32_limit(n * ho * wo)
    three, one = emulated([(xl, gh), (xh, gl), (xh, gh)]), emulated([(xh, gh)])
    assert _rel(three.double(), exact) < limit
    assert _rel(one.double(), exact) > 10 * limit
    assert _rel(one, plain) < 5e-4


def test_wrapper_pads_channels_and_cuts_them_back():
    """The padding helpers the wrappers apply before a bf16 launch: zeros
    appended to the channel dims, values kept."""
    x = torch.randn(1, 3, 4, 5)
    xp = cuda_conv._pad_last(x, 8)
    assert xp.shape == (1, 3, 4, 8) and torch.equal(xp[..., :5], x) and not xp[..., 5:].any()
    assert cuda_conv._pad_last(x, 5) is x
    k = torch.randn(3, 3, 5, 6)
    kp = cuda_conv._pad_last2(k, 8, 8)
    assert kp.shape == (3, 3, 8, 8) and torch.equal(kp[:, :, :5, :6], k)
    assert not kp[:, :, 5:].any() and not kp[:, :, :, 6:].any()
    a = cuda_conv._aligned(torch.randn(17)[1:])
    assert a.is_contiguous() and a.data_ptr() % 16 == 0


# --------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bn", cuda_conv.BN_CHOICES)
def test_bf16_kernels_at_every_tile_width_match_plain_on_card(cuda, bn, monkeypatch):
    """Each BN of the TMA/wgmma conv and weight gradient, forced into the
    plans of CASES, against the plain versions (bf16 conv: one rounding,
    1e-2 of max |out|; weight gradient: f32 sums, 1e-4), the weight gradient
    bit-identical on a second call."""
    import dataclasses

    plans = (cuda_conv.conv_plan, cuda_conv.wgrad_plan)
    monkeypatch.setattr(cuda_conv, "conv_plan",
                        lambda *a, **k: dataclasses.replace(plans[0](*a, **k), bn=bn))
    monkeypatch.setattr(cuda_conv, "wgrad_plan",
                        lambda *a, **k: dataclasses.replace(plans[1](*a, **k), bn=bn))
    for shape in CASES:
        n, hp, wp, cin, kh, kw, cout = shape
        x, k = (torch.from_numpy(a).to(cuda, BF16) for a in _inputs(shape, seed=sum(shape)))
        out = cuda_conv.conv2d_valid(x, k)
        assert _rel(out.float().cpu(), cuda_conv.conv2d_valid_plain(x, k).float().cpu()) < 1e-2
        gy = torch.from_numpy(_inputs(shape, seed=1, wgrad=True)[1]).to(cuda, BF16)
        gk = cuda_conv.conv2d_wgrad(x, gy, kh, kw)
        assert _rel(gk.cpu(), cuda_conv.conv2d_wgrad_plain(x, gy, kh, kw).cpu()) < 1e-4, shape
        assert torch.equal(gk, cuda_conv.conv2d_wgrad(x, gy, kh, kw))


@pytest.mark.cuda
@pytest.mark.parametrize("bn", cuda_conv.F32_BN_CHOICES)
def test_f32_conv_at_every_n_tile_matches_plain_on_card(cuda, bn, monkeypatch):
    """Each BN of the 3xTF32 conv, forced into the plans of CASES (any Cin:
    the wrapper pads it to 4; any Cout), against the plain version at f32
    accuracy (1e-5 of max |out|)."""
    import dataclasses

    plan = cuda_conv.conv_plan
    monkeypatch.setattr(cuda_conv, "conv_plan",
                        lambda *a, **k: dataclasses.replace(plan(*a, **k), bn=bn))
    for shape in CASES + [(2, 15, 19, 60, 3, 3, 13), (1, 9, 40, 13, 3, 3, 60)]:
        x, k = (torch.from_numpy(a).to(cuda) for a in _inputs(shape, seed=sum(shape)))
        out = cuda_conv.conv2d_valid(x, k)
        assert _rel(out.cpu(), cuda_conv.conv2d_valid_plain(x, k).cpu()) < 1e-5, shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_kernel_cases_match_plain_on_card(cuda, dtype):
    """2x2, 3x3 and 8x8 (the f32 kernel's tap rows of 2, 3 and 4); channels
    not multiples of 8 (padded by the wrapper); a kernel taller than wide;
    a 2x2 the plan splits, to a Cout of 200. The fixed-order split sum gives
    the same bits on a second call."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for n, h, w, cin, kh, kw, cout in [(2, 13, 17, 24, 2, 2, 40), (2, 13, 17, 24, 3, 3, 40),
                                       (2, 13, 17, 24, 8, 8, 40), (1, 14, 21, 20, 3, 3, 12),
                                       (1, 20, 30, 72, 3, 2, 64), (1, 40, 52, 136, 2, 2, 200)]:
        x = torch.randn((n, h, w, cin), generator=g, device=cuda).to(dtype)
        gy = (torch.randn((n, h - kh + 1, w - kw + 1, cout), generator=g, device=cuda)
              * 0.1).to(dtype)
        gk = cuda_conv.conv2d_wgrad(x, gy, kh, kw)
        assert gk.shape == (kh, kw, cin, cout) and gk.is_contiguous()
        assert _rel(gk.cpu(), cuda_conv.conv2d_wgrad_plain(x, gy, kh, kw).cpu()) < 1e-4, (cin, kh)
        assert torch.equal(gk, cuda_conv.conv2d_wgrad(x, gy, kh, kw))
