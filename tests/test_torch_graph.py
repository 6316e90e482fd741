"""The port's graph → PyTorch compiler (headpose_tpu_torch.core.graph)
against the JAX package's GraphModel: every layer kind and TF op in small
tf_keras graphs written here (atol = rtol = 1e-5), the committed flagship
fixture's 6 outputs (atol 1e-4: two fp32 conv orders), the parameters
bitwise, and `TrainableGraphHead` trained by `fit` against JAX's (losses
within rtol 1e-5)."""
import os

import numpy as np
import pytest
import torch

from headpose_tpu.core.graph import load_graph_model as jax_load
from headpose_tpu_torch.core.graph import (GraphModel, TrainableGraphHead,
                                           load_graph_model)

FIXTURES = os.path.join(os.path.dirname(__file__), "golden_torch")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = dict(rtol=1e-5, atol=1e-5)


def _outs(y):
    return [np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)
            for t in (y if isinstance(y, tuple) else (y,))]


def run_both(path, xs):
    """(port outputs, JAX outputs, port model, JAX model) on the CPU."""
    ours = load_graph_model(path, device="cpu")
    theirs = jax_load(path)
    return _outs(ours(*xs)), _outs(theirs(*xs)), ours, theirs


def _build(keras, tf, kind):
    """One small graph per layer kind; returns (model, input shapes)."""
    L = keras.layers
    if kind == "conv_same_stride2_odd":
        inp = keras.Input((15, 17, 3))
        a = L.Conv2D(4, 3, strides=2, padding="same", activation="relu")(inp)
        b = L.Conv2D(5, (2, 3), strides=(2, 1), padding="same")(a)
        c = L.Conv2D(5, 3, padding="valid", dilation_rate=2,
                     activation="gelu")(inp)
        d = L.Conv2D(5, 5, strides=2, padding="same",
                     activation="leaky_relu")(c)
        return keras.Model(inp, [b, d]), [(2, 15, 17, 3)]
    if kind == "maxpool":
        inp = keras.Input((13, 10, 4))
        a = L.MaxPooling2D(2, padding="same")(inp)
        b = L.MaxPooling2D(3, strides=2, padding="valid")(inp)
        c = L.MaxPooling2D((3, 2), strides=(2, 3), padding="same")(inp)
        return keras.Model(inp, [a, b, c]), [(2, 13, 10, 4)]
    if kind == "depthwise_separable":
        inp = keras.Input((11, 12, 4))
        a = L.DepthwiseConv2D(3, strides=2, padding="same", depth_multiplier=2,
                              activation="elu")(inp)
        b = L.DepthwiseConv2D(3, dilation_rate=2, padding="same",
                              activation="selu")(inp)
        c = L.SeparableConv2D(6, 3, strides=2, padding="same",
                              depth_multiplier=2, activation="softplus")(b)
        d = L.SeparableConv2D(3, 3, padding="valid", use_bias=False)(b)
        return keras.Model(inp, [a, c, d]), [(2, 11, 12, 4)]
    if kind == "transpose":
        inp = keras.Input((5, 6, 4))
        a = L.Conv2DTranspose(3, 3, strides=2, padding="same",
                              activation="swish")(inp)
        b = L.Conv2DTranspose(2, 2, strides=2, padding="valid")(inp)
        c = L.Conv2DTranspose(2, 1, strides=2, padding="same")(inp)
        d = L.Conv2DTranspose(3, 4, strides=(2, 1), padding="valid",
                              use_bias=False)(inp)
        e = L.Conv2DTranspose(2, 3, strides=3, padding="same")(inp)
        return keras.Model(inp, [a, b, c, d, e]), [(2, 5, 6, 4)]
    if kind == "dense_norms_merges":
        inp = keras.Input((4, 4, 6))
        a = L.BatchNormalization()(inp)
        b = L.BatchNormalization(center=False, epsilon=1e-2)(inp)
        c = L.LayerNormalization()(inp)
        d = L.Dense(6, activation="softsign")(c)
        g = L.GlobalAveragePooling2D(keepdims=True)(a)
        g = L.Conv2D(6, 1, activation="sigmoid")(g)
        e = L.Multiply()([a, b, g])
        f = L.Average()([e, d, c])
        h = L.Add()([f, L.SpatialDropout2D(0.3)(f), L.Dropout(0.5)(f)])
        h = L.ReLU()(h)
        h = L.Activation("tanh")(h)
        flat = L.Flatten()(h)
        r = L.Reshape((8, 12))(flat)
        gap = L.GlobalAveragePooling2D()(h)
        cat = L.Concatenate()([gap, L.Dense(5)(gap)])
        return keras.Model(inp, [r, cat]), [(3, 4, 4, 6)]
    if kind in ("mha_value_first", "mha_key_first"):
        q = keras.Input((6, 16))
        v = keras.Input((4, 16))
        k = keras.Input((4, 16))
        mha = L.MultiHeadAttention(num_heads=2, key_dim=8)
        a = (mha(q, value=v, key=k) if kind == "mha_value_first"
             else mha(q, key=k, value=v))
        s = L.MultiHeadAttention(num_heads=2, key_dim=4)(q, q)
        return (keras.Model([q, v, k], [L.Dense(3)(a), s]),
                [(2, 6, 16), (2, 4, 16), (2, 4, 16)])
    if kind == "tf_op_lambdas":
        inp = keras.Input((5, 5, 4))
        a = inp * 2.0 + 1.0
        r = tf.math.reduce_mean(a, axis=[1, 2], keepdims=True)
        s = tf.math.add(a, y=r)
        t = tf.math.subtract(s, 0.5) / 3.0
        u = tf.math.multiply(tf.nn.relu(t), tf.math.sigmoid(s))
        cat = tf.concat([u, tf.math.tanh(t)], axis=3)
        e = tf.expand_dims(tf.math.reduce_mean(cat, axis=-1), axis=-1)
        return keras.Model(inp, [cat, e]), [(2, 5, 5, 4)]
    if kind == "shared_and_nested":
        si = keras.Input(shape=(8,), name="sub_in")
        sub = keras.Model(si, L.Dense(8, activation="tanh", name="sd")(si),
                          name="subnet")
        oi = keras.Input(shape=(8,), name="outer_in")
        shared = L.Dense(8, activation="tanh", name="shared")
        y = sub(shared(shared(oi)))
        y2 = sub(y)
        return keras.Model(oi, L.Dense(3, name="od")(y2)), [(4, 8)]
    raise KeyError(kind)


KINDS = ("conv_same_stride2_odd", "maxpool", "depthwise_separable",
         "transpose", "dense_norms_merges", "mha_value_first",
         "mha_key_first", "tf_op_lambdas", "shared_and_nested")


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """Every small graph, saved once by tf_keras: {kind: (path, inputs,
    keras outputs)}."""
    keras = pytest.importorskip("tf_keras")
    import tensorflow as tf

    keras.utils.set_random_seed(0)
    out = {}
    rng = np.random.default_rng(7)
    tmp = tmp_path_factory.mktemp("graphs")
    for kind in KINDS:
        model, shapes = _build(keras, tf, kind)
        for layer in model.layers:          # non-trivial BN statistics
            if layer.__class__.__name__ == "BatchNormalization":
                layer.set_weights([rng.uniform(0.5, 1.5, w.shape)
                                   .astype(np.float32)
                                   for w in layer.get_weights()])
        path = str(tmp / f"{kind}.h5")
        model.save(path)
        xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
        want = model.predict(xs if len(xs) > 1 else xs[0], verbose=0)
        out[kind] = (path, xs, want if isinstance(want, list) else [want])
    return out


@pytest.mark.heavy
@pytest.mark.parametrize("kind", KINDS)
def test_layer_kinds_match_jax(graphs, kind):
    path, xs, keras_out = graphs[kind]
    ours, theirs, gm, jgm = run_both(path, xs)
    assert len(ours) == len(theirs) == len(keras_out)
    for o, t, k in zip(ours, theirs, keras_out):
        assert o.shape == t.shape == k.shape
        np.testing.assert_allclose(o, t, **TOL)
        np.testing.assert_allclose(o, k, rtol=1e-4, atol=1e-5)
    assert gm.param_count == jgm.param_count


@pytest.mark.heavy
@pytest.mark.parametrize("suffix", ["h5", "keras"])
def test_keras3_nested_submodel_matches_jax(tmp_path, suffix):
    """Keras 3 numbers a nested submodel's outer calls from 0 (tf-keras
    from 1, covered above): a twice-called submodel in both Keras 3
    formats."""
    keras3 = pytest.importorskip("keras")
    if not keras3.__version__.startswith("3"):
        pytest.skip("stock keras is not Keras 3 here")
    si = keras3.Input(shape=(8,), name="sub_in")
    sub = keras3.Model(si, keras3.layers.Dense(8, activation="tanh")(si),
                       name="subnet")
    oi = keras3.Input(shape=(8,))
    out = keras3.layers.Dense(3)(sub(sub(oi)))
    path = str(tmp_path / f"n.{suffix}")
    keras3.Model(oi, out).save(path)
    x = np.random.default_rng(11).normal(size=(4, 8)).astype(np.float32)
    ours, theirs, gm, _ = run_both(path, [x])
    assert gm.definition.keras3
    np.testing.assert_allclose(ours[0], theirs[0], **TOL)


def test_se_transformer_lambda_pair_matches_jax():
    """The SE-Transformer head fixture: the flatten/unflatten Lambda pair,
    MultiHeadAttention, LayerNormalization and the SE gate, on a 16x16 map
    and on one cell."""
    path = os.path.join(FIXTURES, "se_transformer_head.h5")
    rng = np.random.default_rng(3)
    for shape in ((2, 16, 16, 88), (3, 1, 1, 88)):
        x = rng.normal(size=shape).astype(np.float32)
        ours, theirs, _, _ = run_both(path, [x])
        np.testing.assert_allclose(ours[0], theirs[0], **TOL)


def test_tf_op_layer_pad_in_flat_export(tmp_path):
    """JAX's flat export carries the channel pads as TensorFlowOpLayer Pad
    nodes: its 6 outputs against JAX's compiled graph."""
    from headpose_tpu.pretrained import load_flagship
    from headpose_tpu.tools.h5export import save_unified_h5

    path = str(tmp_path / "flat.h5")
    save_unified_h5(*load_flagship(), path)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 128, 128, 3)).astype(
        np.float32)
    ours, theirs, _, _ = run_both(path, [x])
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(o, t, rtol=1e-5, atol=1e-4)


def test_flagship_fixture_matches_jax():
    """The nested flagship fixture on 8 preprocessed corpus frames: the 6
    outputs within atol 1e-4 + rtol 1e-5 of JAX's GraphModel (two fp32
    conv orders; on real frames the SSD logits and offsets reach the
    hundreds, and one pose of 7.9 degrees differs by 1.5e-4), the params
    bitwise, and the port's native network
    (UnifiedPoseNet.reference_outputs) exactly."""
    from headpose_tpu_torch.ops.image import preprocess
    from headpose_tpu_torch.pretrained import flagship_detector

    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:8]
    x = preprocess(torch.from_numpy(imgs)).numpy()
    path = os.path.join(FIXTURES, "flagship_joined.h5")
    ours, theirs, gm, jgm = run_both(path, [x])
    assert [o.shape for o in ours] == [(8, 512, 1), (8, 384, 1), (8, 512, 16),
                                       (8, 384, 16), (8, 16, 16, 3),
                                       (8, 8, 8, 3)]
    for i, (o, t) in enumerate(zip(ours, theirs)):
        np.testing.assert_allclose(o, t, rtol=1e-5, atol=1e-4, err_msg=i)
    assert gm.param_count == jgm.param_count == 110964
    from headpose_tpu_torch.models.params import flatten_params

    mine = flatten_params(gm.params)
    want = flatten_params(jgm.params)
    assert sorted(mine) == sorted(want)
    for k, v in want.items():
        assert mine[k].tobytes() == np.asarray(v).tobytes(), k
    with torch.no_grad():
        native = flagship_detector(device="cpu").net.reference_outputs(
            torch.from_numpy(x))
    for o, n in zip(ours, native):
        np.testing.assert_array_equal(o, n.numpy())


def test_precision_and_unknown_layers_raise():
    """matmul_precision outside the three strings JAX's modules pass
    ('highest', 'high', 'default') raises: JAX's enum spellings
    'bfloat16' and 'tensorfloat32' too, naming the served strings."""
    md = load_graph_model(os.path.join(FIXTURES, "head96.h5"),
                          device="cpu").definition
    for p in ("bfloat16", "tensorfloat32"):
        with pytest.raises(NotImplementedError,
                           match="'highest', 'high', 'default'"):
            GraphModel(md, matmul_precision=p, device="cpu")


def test_trainable_graph_head_fit_matches_jax():
    """A graph head (head96.h5) fine-tuned by `fit` for 3 epochs as a
    TrainableGraphHead, against JAX's fit of JAX's TrainableGraphHead on the
    same rows and params: per-epoch losses within rtol 1e-5; the graph's L2
    term against JAX's."""
    from headpose_tpu.core.graph import TrainableGraphHead as JaxHead
    from headpose_tpu.data import Dataset as JaxDataset
    from headpose_tpu.train import config_96 as jax_config
    from headpose_tpu.train import fit as jax_fit
    from headpose_tpu_torch.data import Dataset
    from headpose_tpu_torch.models.heads import head_net
    from headpose_tpu_torch.train import config_96, fit

    path = os.path.join(FIXTURES, "head96.h5")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(96, 96)).astype(np.float32)
    y = rng.normal(0, 20, size=(96, 3)).astype(np.float32)
    vx = rng.normal(size=(32, 96)).astype(np.float32)
    vy = rng.normal(0, 20, size=(32, 3)).astype(np.float32)
    kw = dict(total_epochs=3, batch_size=96, seed=0, regularizer_rate=1e-3,
              learning_rate=1e-2)
    gm = load_graph_model(path, device="cpu")
    jgm = jax_load(path)
    net = head_net(TrainableGraphHead(gm, 96), device="cpu")
    assert abs(float(net.l2_penalty(1e-3).detach())
               - float(JaxHead(jgm, 96).l2_penalty(jgm.params, 1e-3))) < 1e-6
    got = fit(config_96(**kw), Dataset(x, y), Dataset(vx, vy),
              spec=TrainableGraphHead(gm, 96), params=gm.params,
              device="cpu")
    want = jax_fit(jax_config(**kw), JaxDataset(x, y), JaxDataset(vx, vy),
                   spec=JaxHead(jgm, 96), params=jgm.params)
    assert len(got.history) == len(want.history) == 3
    for g, w in zip(got.history, want.history):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5)
