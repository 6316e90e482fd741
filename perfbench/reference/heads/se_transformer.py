"""The SE-Transformer pose head, plain PyTorch, float32: the reference's
se_transformer_regr_head (Maaz77/Head-Pose-Estimation-Model
Model-88/attention_model.py:16-80) over a (B, H, W, C) map of T = H·W
tokens of C channels:

  s  = sigmoid(relu(mean_t(x) W1 + b1) W2 + b2)     SE gate, width C / r
  t  = x * s
  q, k, v = t Wq + bq, t Wk + bk, t Wv + bv         `num_heads` of `key_dim`
  o  = concat_h(softmax(q_h k_hᵀ / √key_dim) v_h) Wo + bo
  t1 = LN(t + o)
  t2 = LN(t1 + relu(t1 F1 + f1) F2 + f2)            FFN of `ff_dim`
  y  = relu(t2 Wfc + bfc) Wout + bout               1x1 convs to `hidden`, 3

LN is LayerNormalization over the channels with epsilon 1e-3, Keras's
default.  Departures from Keras's layers, none of which changes the
function: MultiHeadAttention scales the query by 1/√key_dim before Q·Kᵀ,
here the scores are scaled after it; its attention dropout (inactive at
inference) is left out; LayerNormalization computes x·γ' + (β − μ·γ') with
γ' = γ / √(σ² + ε) (tf.nn.batch_normalization), here (x − μ) / √(σ² + ε)·γ
+ β; the reference's flatten and unflatten Lambda layers are reshapes, and
its 1x1 convs products over the channel axis.  Each of these changes the
rounding only.  Every cell's answer depends on the whole map.

Weights `<head>/se/fc{1,2}/{w,b}`, `<head>/{query,key,value}/w` (C, heads,
key_dim) and `/b` (heads, key_dim), `<head>/attn_out/w` (heads, key_dim, C)
and `/b`, `<head>/ln{1,2}/{g,b}`, `<head>/{ff1,ff2,fc,out}/{w,b}`; a dense
`w` as (in, out)."""
from __future__ import annotations

import numpy as np
import torch

COUPLES_CELLS = True
EPS = 1e-3


def build(head_spec: dict, params, prefix: str, device):
    """The head over (B, H, W, C) maps → (B, H, W, out_features)."""
    def t(key):
        return torch.from_numpy(np.asarray(params[prefix + key],
                                           np.float32)).to(device)

    w = {key: t(key) for key in (
        "se/fc1/w", "se/fc1/b", "se/fc2/w", "se/fc2/b", "query/w", "query/b",
        "key/w", "key/b", "value/w", "value/b", "attn_out/w", "attn_out/b",
        "ln1/g", "ln1/b", "ff1/w", "ff1/b", "ff2/w", "ff2/b", "ln2/g",
        "ln2/b", "fc/w", "fc/b", "out/w", "out/b")}
    heads, key_dim = head_spec["num_heads"], head_spec["key_dim"]

    def layer_norm(x, g, b):
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + EPS) * g + b

    def head(x):
        B, H, W, C = x.shape
        x = x.reshape(B, H * W, C)
        s = torch.relu(x.mean(dim=1) @ w["se/fc1/w"] + w["se/fc1/b"])
        s = torch.sigmoid(s @ w["se/fc2/w"] + w["se/fc2/b"])
        t = x * s[:, None, :]

        def project(name):                       # (B, heads, T, key_dim)
            y = t @ w[name + "/w"].reshape(C, -1) + w[name + "/b"].reshape(-1)
            return y.reshape(B, H * W, heads, key_dim).transpose(1, 2)

        q, k, v = project("query"), project("key"), project("value")
        p = torch.softmax(q @ k.transpose(-1, -2) / key_dim ** 0.5, dim=-1)
        o = (p @ v).transpose(1, 2).reshape(B, H * W, heads * key_dim)
        o = o @ w["attn_out/w"].reshape(heads * key_dim, C) + w["attn_out/b"]
        t1 = layer_norm(t + o, w["ln1/g"], w["ln1/b"])
        f = torch.relu(t1 @ w["ff1/w"] + w["ff1/b"]) @ w["ff2/w"] + w["ff2/b"]
        t2 = layer_norm(t1 + f, w["ln2/g"], w["ln2/b"])
        y = torch.relu(t2 @ w["fc/w"] + w["fc/b"]) @ w["out/w"] + w["out/b"]
        return y.reshape(B, H, W, -1)
    return head


def flops(head_spec: dict, cells: int) -> int:
    """The head's products over one map of `cells` tokens; a multiply-add
    counts 2: the gate's two, q/k/v, Q·Kᵀ and P·V, the output projection,
    the FFN's two and the two 1x1s."""
    T, C = cells, head_spec["in_features"]
    hd = head_spec["num_heads"] * head_spec["key_dim"]
    gate = 2 * C * (C // head_spec["reduction"])
    attention = 3 * T * C * hd + 2 * T * T * hd + T * hd * C
    tail = (2 * T * C * head_spec["ff_dim"] + T * C * head_spec["hidden"]
            + T * head_spec["hidden"] * head_spec["out_features"])
    return 2 * (gate + attention + tail)
