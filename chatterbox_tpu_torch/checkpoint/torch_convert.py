"""torch state dict -> the JAX package's parameter layouts (numpy).

The port's own copy of ``chatterbox_tpu/checkpoint/torch_convert.py``: the
reference checkpoints are torch state dicts, and these helpers transpose
each module's tensors once into the JAX package's conventions -- conv
weights (W, Cin, Cout), linear (Cin, Cout) -- and fold weight-norm
parametrizations into plain weights. The converters of ``models/`` build
the JAX-layout tree from them; ``weights.from_jax_tree`` then makes the
port's layouts, so every layout change of the port stays in ``weights.py``.
"""

import numpy as np

from .safetensors_io import load_safetensors


def read_safetensors(path):
    """A reference ``.safetensors`` state dict -> {name: numpy array}, the
    arrays memory-mapped and BF16 ones widened to float32, as the JAX
    package's reader gives them."""
    arrays, bf16 = load_safetensors(path)
    for name in bf16:
        arrays[name] = (arrays[name].astype(np.uint32) << 16).view(np.float32)
    return arrays


def as_numpy(t):
    """A torch tensor or an array -> numpy array (no copy for numpy)."""
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def fold_weight_norm(sd, prefix):
    """The folded weight of a weight-normed torch module, or its plain
    ``weight``. Reads both spellings: ``weight_g``/``weight_v`` and
    ``parametrizations.weight.original0/1``. torch's weight_norm uses dim
    0: w = g * v / ||v|| over the other dims, folded in float64 and cast to
    float32."""
    if f"{prefix}.weight_g" in sd:
        g, v = as_numpy(sd[f"{prefix}.weight_g"]), as_numpy(sd[f"{prefix}.weight_v"])
    elif f"{prefix}.parametrizations.weight.original0" in sd:
        g = as_numpy(sd[f"{prefix}.parametrizations.weight.original0"])
        v = as_numpy(sd[f"{prefix}.parametrizations.weight.original1"])
    else:
        return as_numpy(sd[f"{prefix}.weight"])
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (g.astype(np.float64) / norm * v.astype(np.float64)).astype(np.float32)


def linear(sd, prefix):
    p = {"w": as_numpy(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        p["b"] = as_numpy(sd[f"{prefix}.bias"])
    return p


def embedding(sd, prefix):
    return {"w": as_numpy(sd[f"{prefix}.weight"])}


def conv1d(sd, prefix, weight_norm=False):
    w = fold_weight_norm(sd, prefix) if weight_norm else as_numpy(sd[f"{prefix}.weight"])
    p = {"w": np.transpose(w, (2, 1, 0))}  # (Cout, Cin, W) -> (W, Cin, Cout)
    if f"{prefix}.bias" in sd:
        p["b"] = as_numpy(sd[f"{prefix}.bias"])
    return p


def conv_transpose1d(sd, prefix, weight_norm=False):
    w = fold_weight_norm(sd, prefix) if weight_norm else as_numpy(sd[f"{prefix}.weight"])
    p = {"w": np.transpose(w, (2, 0, 1))}  # (Cin, Cout, W) -> (W, Cin, Cout)
    if f"{prefix}.bias" in sd:
        p["b"] = as_numpy(sd[f"{prefix}.bias"])
    return p


def conv2d(sd, prefix):
    w = as_numpy(sd[f"{prefix}.weight"])  # (Cout, Cin, KH, KW)
    p = {"w": np.transpose(w, (2, 3, 1, 0))}  # -> (KH, KW, Cin, Cout)
    if f"{prefix}.bias" in sd:
        p["b"] = as_numpy(sd[f"{prefix}.bias"])
    return p


def layer_norm(sd, prefix):
    return {"scale": as_numpy(sd[f"{prefix}.weight"]), "bias": as_numpy(sd[f"{prefix}.bias"])}


def rms_norm(sd, prefix):
    return {"scale": as_numpy(sd[f"{prefix}.weight"])}


def batch_norm(sd, prefix):
    p = {
        "mean": as_numpy(sd[f"{prefix}.running_mean"]),
        "var": as_numpy(sd[f"{prefix}.running_var"]),
    }
    if f"{prefix}.weight" in sd:
        p["scale"] = as_numpy(sd[f"{prefix}.weight"])
        p["bias"] = as_numpy(sd[f"{prefix}.bias"])
    return p


def lstm(sd, prefix, num_layers):
    """torch nn.LSTM -> one dict a layer: w_ih (Cin, 4H), w_hh (H, 4H) and
    the two biases summed."""
    layers = []
    for i in range(num_layers):
        w_ih = as_numpy(sd[f"{prefix}.weight_ih_l{i}"]).T
        w_hh = as_numpy(sd[f"{prefix}.weight_hh_l{i}"]).T
        b = as_numpy(sd[f"{prefix}.bias_ih_l{i}"]) + as_numpy(sd[f"{prefix}.bias_hh_l{i}"])
        layers.append({"w_ih": w_ih, "w_hh": w_hh, "b": b})
    return layers


class TrackingDict:
    """Read-through state-dict view recording which keys were read, so a
    converter can name the keys it left unread."""

    def __init__(self, sd, consumed: set):
        self._sd = sd
        self._consumed = consumed

    def __getitem__(self, k):
        self._consumed.add(k)
        return self._sd[k]

    def __contains__(self, k):
        return k in self._sd

    def __iter__(self):
        return iter(self._sd)
