"""One CONF_025 forward step of the PyTorch port against credit_tpu, f32, on
the CPU.

    python tests/manual/torch_port_flagship_parity.py                    # 721x1440
    python tests/manual/torch_port_flagship_parity.py --grid 241 480     # 320x480 padded
    python tests/manual/torch_port_flagship_parity.py --grid 121 320 --pad-lat 19 20

Both models take the same seeded weights: numpy draws of the JAX model's
variables (he-uniform kernels, randomised biases and norm scales, unit
spectral u/v vectors), spectral norm converged, bridged into the port by
`credit_torch.convert_jax.from_jax_variables`. Both run in f32 on the CPU,
where credit_tpu takes its XLA composition (its Pallas gates are off there)
and the port its kernels' plain PyTorch versions (the kernels run only on a
card). Prints, for each output channel group (a 3-D variable's levels, or a
surface variable), the largest |port - reference| over the largest
|reference| in the group.

The configuration is chip_smoke.py's CONF_025 at full width and depth
(dims 128-1024, depths 2/2/8/2, its cross embeds and windows). `--grid`
cuts the latitude-longitude grid and `--pad-lat` its padding; the padded
grid must stay a multiple of 160 rows and columns so that every stage's
feature map holds whole windows. The full 721x1440 grid holds 7.5 times
the activations of `--grid 241 480` (CONF_025's own padding) in each
framework. Kept out of the test suite (tests/manual is not collected).
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import CONF_025, DATA_025  # noqa: E402
from credit_tpu.models import load_model as jax_load_model  # noqa: E402
from credit_tpu.models.spectral_utils import converge_spectral  # noqa: E402
from credit_torch.convert_jax import from_jax_variables  # noqa: E402
from credit_torch.data.channels import ChannelSchema  # noqa: E402
from credit_torch.models import load_model  # noqa: E402


def seeded_variables(model, x: np.ndarray, seed: int):
    """The JAX model's variables drawn with numpy (shapes from eval_shape),
    spectral norm converged: the weights both models take."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def draw(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            lim = np.sqrt(6.0 / np.prod(s.shape[:-1]))
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "'u'" in name or "'v'" in name:
            v = rng.standard_normal(s.shape)
            return (v / np.linalg.norm(v)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return converge_spectral(jax.tree_util.tree_map_with_path(draw, shapes))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, nargs=2, default=(CONF_025["image_height"],
                                                         CONF_025["image_width"]))
    ap.add_argument("--pad-lat", type=int, nargs=2,
                    default=tuple(CONF_025["padding_conf"]["pad_lat"]))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    h, w = args.grid
    model_conf = copy.deepcopy(CONF_025)
    model_conf.update(image_height=h, image_width=w, compute_dtype="float32")
    model_conf["padding_conf"]["pad_lat"] = list(args.pad_lat)
    data = copy.deepcopy(DATA_025)
    data["source"]["ERA5"]["variables"]["diagnostic"] = {"vars_2D": []}
    conf = {"model": model_conf, "data": data}
    schema = ChannelSchema.from_config(conf)

    t0 = time.time()
    jmodel = jax_load_model(conf)
    x = np.random.default_rng(args.seed + 1).standard_normal(
        (1, 1, h, w, jmodel.base_input_channels)).astype(np.float32)
    variables = seeded_variables(jmodel, x, args.seed)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)), np.float32)
    t_ref = time.time() - t0

    t0 = time.time()
    port = load_model(conf, device="cpu")
    state = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables), conf,
                               device="cpu")
    port.load_state_dict(state)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    t_port = time.time() - t0

    print(f"CONF_025 at {h}x{w} (pad_lat {list(args.pad_lat)}), dims {model_conf['dim']}, "
          f"depths {model_conf['depth']}, f32 on the CPU; output {out.shape}; "
          f"credit_tpu {t_ref:.1f} s, port {t_port:.1f} s (init and compile included)")
    if out.shape != ref.shape or out.shape[-1] != schema.n_target:
        raise SystemExit(f"shapes differ: port {out.shape}, reference {ref.shape}, "
                         f"{schema.n_target} targets")
    groups = {}
    for i, name in enumerate(schema.target_names):
        groups.setdefault(name.split("_L")[0], []).append(i)
    worst = 0.0
    for name, idx in groups.items():
        r, o = ref[..., idx], out[..., idx]
        err = float(np.abs(o - r).max() / np.abs(r).max())
        worst = max(worst, err)
        print(f"  {name:8s} ({len(idx):2d} channels): max |port - ref| / max |ref| = {err:.3e}")
    print(f"largest relative error over the groups: {worst:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
