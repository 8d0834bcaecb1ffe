"""The port's pretrained-backbone loader (robo_vln_tpu_torch/utils/pretrained.py)
against the JAX package's graft_pretrained on the same files.

The files are written here, at the tiny HCM's shapes (one block a ResNet
stage), with values from numpy seeds: the DDPPO depth encoder as a full DDPPO
checkpoint (``{"state_dict": {"actor_critic.net.visual_encoder.*"}}``) or a
bare encoder, torchvision's ResNet50 with its BatchNorm statistics, ``fc``
and ``num_batches_tracked``, and HF BERT with a layer more than the config
keeps and a pooler; each as ``.pth`` and as ``.npz``.  After both loaders,
the port's weights equal the JAX-loaded variables converted by
utils/weight_port bitwise, and both policies' forward agrees within 1e-4 in
float32.  The provenance (missing, mismatched and KeyError files, the high
and low levels' merge) is JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.utils.pretrained import graft_pretrained as jax_graft
from robo_vln_tpu_torch.models import build_hierarchical_policies, make_shared_trunk_fn
from robo_vln_tpu_torch.models.encoders.bert import BertEncoder
from robo_vln_tpu_torch.models.encoders.resnet import TVResNet50
from robo_vln_tpu_torch.training.trainer import RoboVLNTrainer
from robo_vln_tpu_torch.utils import pretrained
from robo_vln_tpu_torch.utils.weight_port import (
    high_level_state_dict,
    load_hierarchical_weights,
    low_level_state_dict,
)
from tests.test_torch_agent import B, _jax_step_fn, jax_tiny_hcm, make_inputs
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-4
DDPPO_PREFIX = "actor_critic.net.visual_encoder."
KEYS = {"ddppo_depth": ("DEPTH_ENCODER", "ddppo_checkpoint"),
        "imagenet_rgb": ("RGB_ENCODER", "pretrained_weights"),
        "bert": ("BERT", "pretrained_weights")}
# the JAX hierarchical trainer's merge of the two levels' records
ORDER = {"missing_file": 3, "error": 2, "loaded": 1, "not_in_model": 0}


def _draw(shapes, seed):
    """Numpy tensors for a state_dict's shapes, scaled like a trained net."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, t in shapes.items():
        shape = tuple(t.shape)
        if t.dtype == torch.int64:
            out[k] = np.asarray(rng.integers(0, 100), np.int64)
        elif k.endswith("running_var"):
            out[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif len(shape) > 1:
            out[k] = (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
        else:
            out[k] = (1.0 * k.endswith("weight") + 0.1 * rng.standard_normal(shape)).astype(
                np.float32)
    return out


def _save(sd, path, wrap=False):
    if path.endswith(".npz"):
        np.savez(path, **sd)
    else:
        tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
        torch.save({"state_dict": tensors} if wrap else tensors, path)
    return path


def _bert_shapes(mc, **overrides):
    b = mc.BERT
    kw = dict(vocab_size=b.vocab_size, hidden_size=b.hidden_size, num_layers=b.num_layers,
              num_heads=b.num_heads, intermediate_size=b.intermediate_size)
    return BertEncoder(**{**kw, **overrides}).state_dict()


def write_files(tmp_path, mc, ext, full_ddppo=True):
    """The three backbones' files at the tiny HCM's shapes: {name: path}."""
    high, _ = build_hierarchical_policies(mc)
    gn = _draw(high.depth_encoder.visual_encoder.state_dict(), 11)
    if full_ddppo:
        gn = {DDPPO_PREFIX + k: v for k, v in gn.items()}
        gn["actor_critic.net.state_encoder.rnn.weight_hh_l0"] = np.ones((4, 4), np.float32)
    tv_shapes = dict(high.rgb_encoder.cnn.state_dict())
    tv_shapes.update({k.replace("running_var", "num_batches_tracked"): torch.zeros((), dtype=torch.int64)
                      for k in tv_shapes if k.endswith("running_var")})
    tv = _draw(tv_shapes, 12)
    tv["fc.weight"] = np.ones((10, 2048), np.float32)
    tv["fc.bias"] = np.zeros(10, np.float32)
    bert = _draw(_bert_shapes(mc, num_layers=mc.BERT.num_layers + 1), 13)
    bert["pooler.dense.weight"] = np.ones((4, 4), np.float32)
    return {"ddppo_depth": _save(gn, str(tmp_path / f"ddppo{ext}"), wrap=True),
            "imagenet_rgb": _save(tv, str(tmp_path / f"rgb{ext}")),
            "bert": _save(bert, str(tmp_path / f"bert{ext}"))}


def _configs(files):
    """(JAX MODEL config, port MODEL config) of the tiny HCM with ``files``."""
    jax_mc, port_mc = (mc.clone().defrost() for mc in jax_tiny_hcm()[:2])
    for mc in (jax_mc, port_mc):
        for name, (stanza, key) in KEYS.items():
            mc[stanza][key] = files.get(name, "")
    return jax_mc, port_mc


def _jax_merge(high, low):
    return {k: max(high[k], low[k], key=lambda d: ORDER.get(d.get("status"), 0)) for k in high}


def both_loaders(files):
    """The JAX variables and the port's policies (first loaded with the same
    variables) after each package's loader: (jax high, jax low, JAX merged
    provenance, port high, port low, port provenance)."""
    jax_mc, port_mc = _configs(files)
    _, _, _, _, high_vars, low_vars = jax_tiny_hcm()
    jh, jprov_h = jax_graft(high_vars, jax_mc)
    jl, jprov_l = jax_graft(low_vars, jax_mc)
    high, low = build_hierarchical_policies(port_mc)
    load_hierarchical_weights(high, low, high_vars, low_vars)
    prov = pretrained.merge_provenance(pretrained.graft_pretrained(high, port_mc),
                                       pretrained.graft_pretrained(low, port_mc))
    return jh, jl, _jax_merge(jprov_h, jprov_l), high, low, prov


@pytest.mark.parametrize("full_ddppo", [True, False], ids=["ddppo_checkpoint", "bare_encoder"])
@pytest.mark.parametrize("ext", [".pth", ".npz"])
def test_loaded_weights_match_jax(tmp_path, ext, full_ddppo):
    _, port_mc = _configs({})
    files = write_files(tmp_path, port_mc, ext, full_ddppo)
    jh, jl, jprov, high, low, prov = both_loaders(files)
    assert prov == jprov
    assert {k: v["status"] for k, v in prov.items()} == dict.fromkeys(KEYS, "loaded")

    # every weight, the grafted trunks and BERT among them, JAX's bitwise
    for module, variables, to_sd in ((high, jh, high_level_state_dict),
                                     (low, jl, low_level_state_dict)):
        want = to_sd(jax.tree.map(np.asarray, variables))
        got = module.state_dict()
        for k, v in want.items():
            assert np.array_equal(got[k].numpy(), np.asarray(v, np.float32)), k
    # and the file's tensors, the prefix stripped and the extra BERT layer cut
    sd = pretrained.load_state_dict(files["ddppo_depth"])
    gn = high.depth_encoder.visual_encoder.state_dict()
    for k, t in gn.items():
        assert np.array_equal(t.numpy(), sd[DDPPO_PREFIX + k if full_ddppo else k]), k
    assert len(high.embedding_layer.encoder.layer) == port_mc.BERT.num_layers

    # the forward of both policies over a window, JAX's within 1e-4
    jax_mc, _ = _configs(files)
    _, _, jhigh, jlow, _, _ = jax_tiny_hcm()
    obs, masks = make_inputs(np.random.default_rng(4))
    step = _jax_step_fn(jax_mc, jhigh, jlow, jh)
    hh0, lh0 = jhigh.initial_hidden(B), jlow.initial_hidden(B)
    want = step(jh, jl, jax.tree.map(jnp.asarray, obs), jnp.asarray(masks), hh0, lh0)
    tobs = {k: torch.from_numpy(v) for k, v in obs.items()}
    with torch.no_grad():
        tobs.update(make_shared_trunk_fn(high)(tobs))
        tmasks = torch.from_numpy(masks)
        logits, hh = high(tobs, high.initial_hidden(B), None, tmasks)
        actions, stop, lh = low(tobs, low.initial_hidden(B), None, tmasks, logits.argmax(-1))
    for name, g, w in zip(("actions", "stop", "logits", "high hidden", "low hidden"),
                          (actions, stop, logits, hh, lh), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)


def _mismatched_bert(tmp_path, mc):
    return _save(_draw(_bert_shapes(mc, hidden_size=2 * mc.BERT.hidden_size), 14),
                 str(tmp_path / "bert_wide.npz"))


def _deeper_rgb(tmp_path, mc):
    shapes = TVResNet50(blocks=(2, 1, 1, 1)).state_dict()
    return _save(_draw(shapes, 15), str(tmp_path / "rgb_deep.pth"))


def _ddppo_without_compression(tmp_path, mc):
    high, _ = build_hierarchical_policies(mc)
    sd = _draw(high.depth_encoder.visual_encoder.state_dict(), 16)
    sd = {DDPPO_PREFIX + k: v for k, v in sd.items() if not k.startswith("compression.")}
    return _save(sd, str(tmp_path / "ddppo_partial.pth"), wrap=True)


@pytest.mark.parametrize("case,backbone,make,status", [
    ("missing", "bert", lambda tmp_path, mc: str(tmp_path / "absent.npz"), "missing_file"),
    ("empty_path", "imagenet_rgb", lambda tmp_path, mc: "", "missing_file"),
    ("shape_mismatch", "bert", _mismatched_bert, "error"),
    ("more_blocks", "imagenet_rgb", _deeper_rgb, "error"),
    ("missing_key", "ddppo_depth", _ddppo_without_compression, "error"),
])
def test_provenance_matches_jax(tmp_path, case, backbone, make, status):
    """Each faulty file leaves its backbone as it was, with JAX's record;
    the other two load."""
    _, port_mc = _configs({})
    files = write_files(tmp_path, port_mc, ".npz")
    files[backbone] = make(tmp_path, port_mc)
    _, _, _, _, high_vars, _ = jax_tiny_hcm()
    jh, jl, jprov, high, low, prov = both_loaders(files)
    assert prov == jprov
    assert prov[backbone]["status"] == status
    assert all(v["status"] == "loaded" for k, v in prov.items() if k != backbone)
    if case == "missing_key":
        assert prov[backbone]["detail"] == "missing key 'compression.0.weight'"
    before = {"bert": ("embedding_layer", "embedding_layer"),
              "imagenet_rgb": ("rgb_encoder.cnn", "rgb_encoder/cnn"),
              "ddppo_depth": ("depth_encoder.visual_encoder",
                              "depth_encoder/visual_encoder")}[backbone]
    got = high.get_submodule(before[0]).state_dict()
    want = high_level_state_dict(jax.tree.map(np.asarray, jh))
    prefix = before[0] + "."
    for k, t in got.items():
        assert np.array_equal(t.numpy(), np.asarray(want[prefix + k], np.float32)), k


def test_high_and_low_provenance_merge():
    """BERT only in the high level: loaded there, not_in_model in the low,
    loaded merged; a file missing for one level is missing merged, and an
    error beats a load."""
    loaded = {"status": "loaded", "path": "f"}
    missing = {"status": "missing_file", "path": "f"}
    error = {"status": "error", "path": "f"}
    absent = {"status": "not_in_model"}
    records = [({"bert": loaded}, {"bert": absent}), ({"bert": absent}, {"bert": loaded}),
               ({"bert": missing}, {"bert": loaded}), ({"bert": loaded}, {"bert": error}),
               ({"bert": absent}, {"bert": absent}), ({"bert": error}, {"bert": missing})]
    for high, low in records:
        assert pretrained.merge_provenance(high, low) == _jax_merge(high, low)


def test_flat_trainer_loads_the_trunks(tmp_path):
    """RoboVLNTrainer grafts its policy's trunks at set-up (CMA: no BERT)."""
    from robo_vln_tpu_torch.config import get_config
    from tests.test_torch_flat_trainer import flat_opts

    _, port_mc = _configs({})
    files = write_files(tmp_path, port_mc, ".pth", full_ddppo=False)
    opts = flat_opts(tmp_path, hw=64, **{
        "MODEL.CMA.use": True, "MODEL.DEPTH_ENCODER.ddppo_checkpoint": files["ddppo_depth"],
        "MODEL.RGB_ENCODER.pretrained_weights": files["imagenet_rgb"],
        "MODEL.BERT.pretrained_weights": files["bert"]})
    trainer = RoboVLNTrainer(get_config(opts=opts))
    trainer._setup_policy()
    assert {k: v["status"] for k, v in trainer.pretrained_backbones.items()} == {
        "ddppo_depth": "loaded", "imagenet_rgb": "loaded", "bert": "not_in_model"}
    sd = pretrained.load_state_dict(files["imagenet_rgb"])
    for k, t in trainer.policy.rgb_encoder.cnn.state_dict().items():
        assert np.array_equal(t.numpy(), sd[k]), k


def test_export_torch_to_npz(tmp_path):
    sd = {"a.weight": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(2, np.float32)}
    pth = _save(sd, str(tmp_path / "w.pth"), wrap=True)
    pretrained.export_torch_to_npz(pth, str(tmp_path / "w.npz"))
    got = pretrained.load_state_dict(str(tmp_path / "w.npz"))
    assert set(got) == set(sd) and all(np.array_equal(got[k], sd[k]) for k in sd)


def test_featurize_buffer_script_grafts_the_trunks(tmp_path):
    """robo_vln_tpu_torch/scripts/featurize_buffer.py builds the policy as
    the trainer does, the pretrained trunks and BERT read from their files,
    then featurizes the buffer: the store's fingerprint is the grafted
    high level's, and a second run reuses it."""
    import json
    import os

    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.scripts import featurize_buffer
    from robo_vln_tpu_torch.training.featurize import META, trunk_fingerprint
    from tests.test_torch_flat_trainer import cli
    from tests.test_torch_trainer import PORT_CONFIGS, buffers, tiny_opts

    files = write_files(tmp_path, get_config(opts=tiny_opts(tmp_path)).MODEL, ".npz")
    opts = tiny_opts(tmp_path, **{"MODEL.DEPTH_ENCODER.ddppo_checkpoint": files["ddppo_depth"],
                                  "MODEL.RGB_ENCODER.pretrained_weights": files["imagenet_rgb"],
                                  "MODEL.BERT.pretrained_weights": files["bert"]})
    buffers(tmp_path, n_eps=2, n_eval=0)
    argv = ["--exp-config", str(PORT_CONFIGS / "hierarchical_cma.yaml"), *cli(opts)]
    assert featurize_buffer.main(argv) == 0
    cfg = get_config(opts=opts)
    high, _ = build_hierarchical_policies(cfg.MODEL)
    assert pretrained.graft_pretrained(high, cfg.MODEL)["bert"]["status"] == "loaded"
    meta_path = os.path.join(str(tmp_path / "train_buf") + ".features", META)
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["fingerprint"] == trunk_fingerprint(high) and meta["episodes"] == 2
    stamp = os.path.getmtime(meta_path)
    assert featurize_buffer.main(argv) == 0
    assert os.path.getmtime(meta_path) == stamp
