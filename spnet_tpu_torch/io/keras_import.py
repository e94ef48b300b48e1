"""Keras -> flax-layout pretrained-weight import, for the backbone zoo,
then into the port's backbone.

Counterpart of `spnet_tpu/io/keras_import.py` (its own copy: the port
imports nothing of the JAX package).  `keras_*_to_flax` map a Keras
`include_top=False` weight set of MobileNet, Xception, InceptionResNetV2
or NASNetMobile onto the (params, batch_stats) trees of the JAX package's
backbone, in plain numpy, as JAX does; `apply_backbone_weights` then puts
those trees through `convert.py`'s leaf conversion into the port's
backbone, checked leaf by leaf (every leaf lands on a key of the
backbone, with its shape, and every key is filled).  DarkNet19 has no
Keras counterpart and raises ValueError.

Input is a Keras model object or a weights file (.h5 / .keras /
.weights.h5), anything `keras.saving.load_model` or `model.load_weights`
takes.  `keras` (with h5py for files) is imported only inside
`load_keras_backbone`, with the backend its environment selects
(`KERAS_BACKEND`; 'torch' needs no other framework); the rest of the
module needs numpy and torch only.  ImageNet weights must be a local file
(how to make one: `load_keras_backbone`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spnet_tpu_torch.convert import flax_to_state_dict


def _split_bn(weights):
    """Keras BN weight list [gamma, beta, moving_mean, moving_var] ->
    (params, stats) dicts for flax BatchNorm."""
    gamma, beta, mean, var = (np.asarray(w) for w in weights)
    return (
        {"scale": gamma, "bias": beta},
        {"mean": mean, "var": var},
    )


def keras_mobilenet_to_flax(model) -> tuple[dict, dict]:
    """Map a Keras MobileNet(include_top=False) to (params, batch_stats)
    trees matching `spnet_tpu.models.mobilenet.MobileNet`.

    Layer correspondence (Keras name -> flax path):
      conv1 / conv1_bn          -> conv1/{conv,bn}
      conv_dw_<i> / _bn         -> block<i>/{depthwise,bn_dw}
      conv_pw_<i> / _bn         -> block<i>/{pointwise,bn}
    Depthwise kernels transpose (kh, kw, C, 1) -> (kh, kw, 1, C), the
    flax feature_group_count layout.
    """
    by_name = {layer.name: layer for layer in model.layers}

    params: dict = {}
    stats: dict = {}

    conv1 = np.asarray(by_name["conv1"].get_weights()[0])
    bn_p, bn_s = _split_bn(by_name["conv1_bn"].get_weights())
    params["conv1"] = {"conv": {"kernel": conv1}, "bn": bn_p}
    stats["conv1"] = {"bn": bn_s}

    for i in range(1, 14):
        dw = np.asarray(by_name[f"conv_dw_{i}"].get_weights()[0])
        dw = np.transpose(dw, (0, 1, 3, 2))  # (kh,kw,C,1) -> (kh,kw,1,C)
        pw = np.asarray(by_name[f"conv_pw_{i}"].get_weights()[0])
        bndw_p, bndw_s = _split_bn(by_name[f"conv_dw_{i}_bn"].get_weights())
        bnpw_p, bnpw_s = _split_bn(by_name[f"conv_pw_{i}_bn"].get_weights())
        params[f"block{i}"] = {
            "depthwise": {"kernel": dw},
            "bn_dw": bndw_p,
            "pointwise": {"kernel": pw},
            "bn": bnpw_p,
        }
        stats[f"block{i}"] = {"bn_dw": bndw_s, "bn": bnpw_s}

    return params, stats


def keras_xception_to_flax(model) -> tuple[dict, dict]:
    """Map a Keras Xception(include_top=False) to (params, batch_stats)
    trees matching `spnet_tpu.models.xception.Xception`.

    Layer correspondence (Keras name -> flax path):
      block1_conv1/_bn               -> conv1/{conv,bn}
      block1_conv2/_bn               -> conv2/{conv,bn}
      block{2,3,4}_sepconv{1,2}/_bn  -> block{2,3,4}/sep{1,2}
      conv2d{,_1,_2}/batch_normalization{,_1,_2}
                                     -> block{2,3,4}/shortcut
      block{5..12}_sepconv{1,2,3}    -> middle{1..8}/sep{1,2,3}
      conv2d_3/batch_normalization_3 -> exit_shortcut
      block13_sepconv{1,2}           -> exit_sep{1,2}
      block14_sepconv{1,2}           -> exit_sep{3,4}
    Keras SeparableConv2D holds [depthwise (kh,kw,C,1), pointwise];
    the depthwise kernel transposes to flax's (kh,kw,1,C) layout.
    """
    by_name = {layer.name: layer for layer in model.layers}

    params: dict = {}
    stats: dict = {}

    def conv_bn(kconv: str, kbn: str):
        kernel = np.asarray(by_name[kconv].get_weights()[0])
        bn_p, bn_s = _split_bn(by_name[kbn].get_weights())
        return {"conv": {"kernel": kernel}, "bn": bn_p}, {"bn": bn_s}

    def sep_bn(ksep: str):
        dw, pw = (np.asarray(w) for w in by_name[ksep].get_weights())
        dw = np.transpose(dw, (0, 1, 3, 2))  # (kh,kw,C,1) -> (kh,kw,1,C)
        bn_p, bn_s = _split_bn(by_name[ksep + "_bn"].get_weights())
        return (
            {"depthwise": {"kernel": dw}, "pointwise": {"kernel": pw},
             "bn": bn_p},
            {"bn": bn_s},
        )

    params["conv1"], stats["conv1"] = conv_bn("block1_conv1",
                                              "block1_conv1_bn")
    params["conv2"], stats["conv2"] = conv_bn("block1_conv2",
                                              "block1_conv2_bn")

    # The 4 residual 1x1 convs carry auto-generated names ("conv2d",
    # "conv2d_1", ... — uniquified PER PROCESS by Keras, so absolute
    # names are unreliable).  Identify them structurally: the only plain
    # Conv2D / BatchNormalization layers outside block1/sepconv, in
    # graph order block2, block3, block4, exit.
    res_convs = [l for l in model.layers
                 if l.__class__.__name__ == "Conv2D"
                 and not l.name.startswith("block1")]
    res_bns = [l for l in model.layers
               if l.__class__.__name__ == "BatchNormalization"
               and not l.name.endswith("_bn")]
    assert len(res_convs) == 4 and len(res_bns) == 4, (
        [l.name for l in res_convs], [l.name for l in res_bns])

    def res_names(i: int):
        return res_convs[i].name, res_bns[i].name

    for n, kblock in enumerate(("block2", "block3", "block4")):
        p: dict = {}
        s: dict = {}
        p["shortcut"], s["shortcut"] = conv_bn(*res_names(n))
        for j in (1, 2):
            p[f"sep{j}"], s[f"sep{j}"] = sep_bn(f"{kblock}_sepconv{j}")
        params[kblock] = p
        stats[kblock] = s

    for m in range(8):
        p, s = {}, {}
        for j in (1, 2, 3):
            p[f"sep{j}"], s[f"sep{j}"] = sep_bn(f"block{m + 5}_sepconv{j}")
        params[f"middle{m + 1}"] = p
        stats[f"middle{m + 1}"] = s

    params["exit_shortcut"], stats["exit_shortcut"] = conv_bn(*res_names(3))
    for flax_name, keras_name in (
        ("exit_sep1", "block13_sepconv1"),
        ("exit_sep2", "block13_sepconv2"),
        ("exit_sep3", "block14_sepconv1"),
        ("exit_sep4", "block14_sepconv2"),
    ):
        params[flax_name], stats[flax_name] = sep_bn(keras_name)

    return params, stats


def _auto_named(model, cls: str, stem: str, exclude=()):
    """Layers of class `cls` whose names are Keras auto-names
    (`stem`, `stem_1`, ...), sorted by the auto-name counter.

    Keras uniquifies auto-names with a PER-PROCESS counter, so absolute
    indices are unreliable — but within one model the counter is
    monotonic in creation order, which is exactly the order the
    architecture code created the layers in.  `model.layers` itself is
    topologically sorted and may interleave parallel branches, so it
    cannot be used directly."""
    import re

    pat = re.compile(rf"^{re.escape(stem)}(_(\d+))?$")
    found = []
    for layer in model.layers:
        if layer.__class__.__name__ != cls or layer.name in exclude:
            continue
        m = pat.match(layer.name)
        if m:
            found.append((int(m.group(2) or 0), layer))
    found.sort(key=lambda t: t[0])
    return [layer for _, layer in found]


#: Flax ConvBN paths of InceptionResNetV2 in Keras CREATION order (the
#: order `__call__` executes them, which mirrors
#: keras.applications.inception_resnet_v2's build order: stem, mixed_5b
#: branches 0/1/2/pool, 10x block35 (branches 0/1/2), mixed_6a, 20x
#: block17, mixed_7a, 10x block8).  The trailing conv_7b is explicitly
#: named in Keras and handled separately.
def _irv2_convbn_paths() -> list[tuple[str, ...]]:
    paths: list[tuple[str, ...]] = [
        (n,) for n in ("stem1", "stem2", "stem3", "stem4", "stem5",
                       "m5b_b0", "m5b_b1a", "m5b_b1b", "m5b_b2a",
                       "m5b_b2b", "m5b_b2c", "m5b_b3")
    ]
    for i in range(10):
        paths += [(f"block35_{i + 1}", b)
                  for b in ("b0", "b1a", "b1b", "b2a", "b2b", "b2c")]
    paths += [(n,) for n in ("m6a_b0", "m6a_b1a", "m6a_b1b", "m6a_b1c")]
    for i in range(20):
        paths += [(f"block17_{i + 1}", b)
                  for b in ("b0", "b1a", "b1b", "b1c")]
    paths += [(n,) for n in ("m7a_b0a", "m7a_b0b", "m7a_b1a", "m7a_b1b",
                             "m7a_b2a", "m7a_b2b", "m7a_b2c")]
    for i in range(10):
        paths += [(f"block8_{i + 1}", b)
                  for b in ("b0", "b1a", "b1b", "b1c")]
    return paths


def keras_irv2_to_flax(model) -> tuple[dict, dict]:
    """Map a Keras InceptionResNetV2(include_top=False) to
    (params, batch_stats) trees matching
    `spnet_tpu.models.inception_resnet_v2.InceptionResNetV2`.

    All 203 conv+BN pairs except `conv_7b` carry Keras auto-names
    (`conv2d_N` / `batch_normalization_N`); they are zipped against the
    flax ConvBN paths in creation order (`_irv2_convbn_paths`).  The 40
    residual `up` projections are explicitly named `block{35,17,8}_N_conv`
    (bias, no BN).  Keras IRv2 BatchNorm is gamma-less (scale=False):
    weights are [beta, mean, var], matching ConvBN(bn_scale=False)."""
    by_name = {layer.name: layer for layer in model.layers}

    convs = _auto_named(model, "Conv2D", "conv2d")
    bns = _auto_named(model, "BatchNormalization", "batch_normalization")
    paths = _irv2_convbn_paths()
    if not (len(convs) == len(bns) == len(paths)):
        raise ValueError(
            f"unexpected IRv2 layer census: {len(convs)} auto convs, "
            f"{len(bns)} auto BNs, expected {len(paths)}"
        )

    params: dict = {}
    stats: dict = {}

    def set_at(tree, path, leaf):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def scaleless_bn(layer):
        beta, mean, var = (np.asarray(w) for w in layer.get_weights())
        return {"bias": beta}, {"mean": mean, "var": var}

    for path, kconv, kbn in zip(paths, convs, bns):
        kernel = np.asarray(kconv.get_weights()[0])
        bn_p, bn_s = scaleless_bn(kbn)
        set_at(params, path, {"conv": {"kernel": kernel}, "bn": bn_p})
        set_at(stats, path, {"bn": bn_s})

    kernel = np.asarray(by_name["conv_7b"].get_weights()[0])
    bn_p, bn_s = scaleless_bn(by_name["conv_7b_bn"])
    params["conv_7b"] = {"conv": {"kernel": kernel}, "bn": bn_p}
    stats["conv_7b"] = {"bn": bn_s}

    for prefix, count in (("block35", 10), ("block17", 20), ("block8", 10)):
        for i in range(1, count + 1):
            k, b = by_name[f"{prefix}_{i}_conv"].get_weights()
            params[f"{prefix}_{i}"]["up"] = {
                "kernel": np.asarray(k), "bias": np.asarray(b)
            }

    return params, stats


#: flax cell name -> Keras NASNet block id, for the Mobile configuration
#: (num_blocks=4).  Keras builds cells as stem_1, stem_2, normals
#: '0'..'3', 'reduce_4', normals '5'..'8', 'reduce_8', normals '9'..'12'
#: (keras.applications.nasnet.NASNet's cell loop).
def _nasnet_cell_ids(num_blocks: int = 4) -> dict[str, str]:
    ids = {"stem_red1": "stem_1", "stem_red2": "stem_2",
           "red1": f"reduce_{num_blocks}", "red2": f"reduce_{2 * num_blocks}"}
    for i in range(num_blocks):
        ids[f"normal1_{i}"] = f"{i}"
        ids[f"normal2_{i}"] = f"{num_blocks + i + 1}"
        ids[f"normal3_{i}"] = f"{2 * num_blocks + i + 1}"
    return ids


def keras_nasnet_to_flax(model) -> tuple[dict, dict]:
    """Map a Keras NASNetMobile(include_top=False) to (params,
    batch_stats) trees matching `spnet_tpu.models.nasnet.NASNetMobile`.

    Keras NASNet names every layer explicitly per cell block-id
    (`separable_conv_{1,2}[_bn]_{normal,reduction}_<slot>_<id>`,
    `{normal,reduction}_conv_1_<id>`, `adjust_*_<id>`, `stem_conv1`),
    so the mapping is pure name translation — see `_nasnet_cell_ids`
    for the cell-id correspondence.  Keras SeparableConv2D holds
    [depthwise (kh,kw,C,1), pointwise]; depthwise transposes to flax's
    (kh,kw,1,C)."""
    by_name = {layer.name: layer for layer in model.layers}

    def conv(name):
        return {"kernel": np.asarray(by_name[name].get_weights()[0])}

    def bn(name):
        return _split_bn(by_name[name].get_weights())

    def sep_block(kid: str):
        """Keras _separable_conv_block '<kind>_<slot>_<id>' ->
        flax SepBlock {sep1_dw, sep1_pw, bn1, sep2_dw, sep2_pw, bn2}."""
        p: dict = {}
        s: dict = {}
        for j in (1, 2):
            dw, pw = (np.asarray(w)
                      for w in by_name[f"separable_conv_{j}_{kid}"]
                      .get_weights())
            p[f"sep{j}_dw"] = {"kernel": np.transpose(dw, (0, 1, 3, 2))}
            p[f"sep{j}_pw"] = {"kernel": pw}
            bn_p, bn_s = bn(f"separable_conv_{j}_bn_{kid}")
            p[f"bn{j}"] = bn_p
            s[f"bn{j}"] = bn_s
        return p, s

    def adjust(kid: str):
        """Keras _adjust_block for cell `kid` -> flax Adjust subtree
        (projection / factorized-reduction / identity)."""
        if f"adjust_conv_projection_{kid}" in by_name:
            bn_p, bn_s = bn(f"adjust_bn_{kid}")
            return ({"proj": conv(f"adjust_conv_projection_{kid}"),
                     "bn": bn_p}, {"bn": bn_s})
        if f"adjust_conv_1_{kid}" in by_name:
            bn_p, bn_s = bn(f"adjust_bn_{kid}")
            return ({"conv1": conv(f"adjust_conv_1_{kid}"),
                     "conv2": conv(f"adjust_conv_2_{kid}"),
                     "bn": bn_p}, {"bn": bn_s})
        return None, None

    params: dict = {}
    stats: dict = {}

    params["stem_conv"] = conv("stem_conv1")
    bn_p, bn_s = bn("stem_bn1")
    params["stem_bn"] = bn_p
    stats["stem_bn"] = bn_s

    for flax_cell, kid in _nasnet_cell_ids().items():
        kind = "reduction" if ("red" in flax_cell) else "normal"
        p: dict = {}
        s: dict = {}
        adj_p, adj_s = adjust(kid)
        if adj_p is not None:
            p["adjust"] = adj_p
            s["adjust"] = adj_s
        p["conv1"] = conv(f"{kind}_conv_1_{kid}")
        p["bn1"], s["bn1"] = bn(f"{kind}_bn_1_{kid}")
        slots = (("left1", "left1"), ("right1", "right1"),
                 ("left2", "left2"), ("right2", "right2"),
                 ("left5", "left5")) if kind == "normal" else \
                (("left1", "left1"), ("right1", "right1"),
                 ("right2", "right2"), ("right3", "right3"),
                 ("left5", "left4"))
        for flax_slot, kslot in slots:
            p[flax_slot], s[flax_slot] = sep_block(f"{kind}_{kslot}_{kid}")
        params[flax_cell] = p
        stats[flax_cell] = s

    return params, stats


#: Keras application constructor of each backbone with Keras weights
KERAS_APPLICATIONS = {
    "MobileNet": ("MobileNet", keras_mobilenet_to_flax),
    "MobileNetTiny": ("MobileNet", keras_mobilenet_to_flax),
    "Xception": ("Xception", keras_xception_to_flax),
    "InceptionResNetV2": ("InceptionResNetV2", keras_irv2_to_flax),
    "NASNetMobile": ("NASNetMobile", keras_nasnet_to_flax),
}


def load_keras_backbone(path_or_model, backbone: str) -> tuple[dict, dict]:
    """Load Keras weights for `backbone` from a model object or a file and
    map them to flax-layout (params, batch_stats) trees.

    A file goes first through `keras.saving.load_model`; a bare weights
    file that it refuses is loaded into the backbone's Keras application,
    built with weights=None (JAX's sequence).  There is no network here,
    so ImageNet weights must be a LOCAL file; on a machine with one:
        python -c "import keras; m = keras.applications.Xception(
            include_top=False, weights='imagenet');
            m.save_weights('xception_imagenet.weights.h5')"
    then pass that file as ModelConfig.pretrained / --pretrained."""
    if backbone not in KERAS_APPLICATIONS:
        raise ValueError(
            f"pretrained Keras import supports MobileNet, Xception, "
            f"InceptionResNetV2 and NASNetMobile, not {backbone!r}.")
    ctor, to_flax = KERAS_APPLICATIONS[backbone]
    model = path_or_model
    if isinstance(path_or_model, (str, os.PathLike)):
        path = os.fspath(path_or_model)
        if not os.path.exists(path):
            raise FileNotFoundError(f"pretrained weights {path!r} not found")
        try:
            import keras
        except ImportError as e:
            raise ImportError(
                "--pretrained reads Keras weight files and needs the keras "
                "package (and h5py); it is not installed here") from e
        try:
            model = keras.saving.load_model(path)
        except Exception:  # noqa: BLE001 (a bare weights file; JAX's order)
            model = getattr(keras.applications, ctor)(
                include_top=False, weights=None, input_shape=(None, None, 3))
            model.load_weights(path)
    return to_flax(model)


def apply_backbone_weights(model: torch.nn.Module, bb_params: dict,
                           bb_stats: dict) -> None:
    """Load flax-layout backbone trees into `model.backbone` in place (its
    device and float32 kept).  Raises ValueError naming every leaf with
    no key or another shape, and every key left unfilled."""
    model.backbone.load_state_dict(
        flax_to_state_dict(bb_params, bb_stats, model.backbone))
