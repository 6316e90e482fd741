"""Write the Keras-H5 fixtures of the port's H5 tests and chip phase.

    python tests/golden_torch/make_h5_fixtures.py [--out tests/golden_torch]
    python tests/golden_torch/make_h5_fixtures.py --check   # write nothing

It needs the JAX package, h5py and tf_keras, and writes, from the shipped
flagship 'unified-stoqa9pt-hrchr82r':

  flagship_joined.h5        the flagship as the reference's JoinModels
                            format: the backbone and SSD heads of JAX's flat
                            export (tools.h5export.save_unified_h5) with the
                            two pose heads nested as Functional submodels
                            ('reg1' on re_lu_10, 'reg2' on re_lu_15),
                            joined and saved by tf_keras;
  se_transformer_head.h5    JAX's SETransformerHead() initialised from
                            PRNGKey(0), written by save_head_h5;
  head96.h5                 the flagship's head96, written by save_head_h5;

and beside each H5 its h5py-free twin: <name>_config.json (the
model_config attribute) and <name>_weights.npz (every array of
model_weights, keyed by its path under the group, e.g.
conv2d/conv2d/kernel:0), which core.h5io._model_from_parts reads.

Each twin, as written, is parsed by _model_from_parts and held to the JAX
package's read_model of its H5 file (the same layers, configs, inbound and
call kwargs, every weight bit for bit), so a reader without h5py rests on
JAX's reader, not only on the port's.  `--check` does that for the files
in `--out` and writes nothing.
"""
import argparse
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.dirname(HERE))
NAMES = ("flagship_joined", "se_transformer_head", "head96")


def write_twin(h5_path: str) -> None:
    """<name>_config.json + <name>_weights.npz of one Keras H5 file: what
    the port's reader takes from it (core.h5io._read_parts)."""
    from headpose_tpu_torch.core.h5io import _read_parts

    config, weights = _read_parts(h5_path)
    stem = h5_path[:-3]
    with open(f"{stem}_config.json", "w") as f:
        json.dump(config, f)
    with open(f"{stem}_weights.npz", "wb") as f:
        np.savez(f, **weights)


def check_twin(h5_path: str) -> int:
    """Raise unless the twin beside `h5_path` parses to JAX's read_model
    of the file; returns the number of weight arrays compared."""
    from headpose_tpu.core.h5io import read_model
    from headpose_tpu_torch.core.h5io import _model_from_parts
    from test_torch_h5io import assert_same_model

    stem = h5_path[:-3]
    with open(f"{stem}_config.json") as f:
        config = json.load(f)
    with np.load(f"{stem}_weights.npz") as w:
        weights = {k: w[k] for k in w.files}
    assert_same_model(_model_from_parts(config, weights), read_model(h5_path),
                      os.path.basename(stem))
    return len(weights)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=HERE)
    parser.add_argument("--check", action="store_true",
                        help="check the twins in --out; write nothing")
    args = parser.parse_args()
    out = args.out

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.check:
        for name in NAMES:
            n = check_twin(os.path.join(out, f"{name}.h5"))
            print(name, "twin equals JAX's read_model:", n, "arrays")
        return
    import tf_keras

    from headpose_tpu.models.heads import SETransformerHead
    from headpose_tpu.pretrained import load_flagship
    from headpose_tpu.tools.h5export import save_head_h5, save_unified_h5

    model, params = load_flagship()
    with tempfile.TemporaryDirectory() as tmp:
        flat = os.path.join(tmp, "flat.h5")
        save_unified_h5(model, params, flat)
        reg = {}
        for name, spec, p in (("reg1", model.head88, params["head88"]),
                              ("reg2", model.head96, params["head96"])):
            reg[name] = os.path.join(tmp, f"{name}.h5")
            save_head_h5(spec, p, reg[name], name=name)
        det = tf_keras.models.load_model(flat, compile=False)
        h88 = tf_keras.models.load_model(reg["reg1"], compile=False)
        h96 = tf_keras.models.load_model(reg["reg2"], compile=False)
        pose88 = h88(det.get_layer("re_lu_10").output)
        pose96 = h96(det.get_layer("re_lu_15").output)
        joined = tf_keras.Model(det.inputs, det.outputs[:4] + [pose88, pose96])
        joined.save(os.path.join(out, "flagship_joined.h5"))

    se = SETransformerHead()
    save_head_h5(se, se.init(jax.random.PRNGKey(0)),
                 os.path.join(out, "se_transformer_head.h5"))
    save_head_h5(model.head96, params["head96"],
                 os.path.join(out, "head96.h5"))
    for name in NAMES:
        path = os.path.join(out, f"{name}.h5")
        write_twin(path)
        n = check_twin(path)
        print(name, os.path.getsize(path), "bytes; twin equals JAX's "
              f"read_model: {n} arrays")


if __name__ == "__main__":
    main()
