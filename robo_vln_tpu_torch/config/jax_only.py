"""Keys of the JAX package's config tree (robo_vln_tpu/config/default.py)
that the port's tree does not have, with their JAX defaults.

A yaml or CLI option may still set one: ``ConfigTree`` merges a key it does
not know.  :func:`check_jax_only_keys` (run by ``get_config``) refuses, before
any work, a key of :data:`UNPORTED` set to another value than its JAX
default, naming the ROADMAP item that would port it: at the default the port
computes what the JAX package computes, elsewhere it would drop the key
without a word.  The keys of :data:`INERT` are taken at any value: no value
of them changes a result of the JAX package either, for the reason given.
The port keeps its own copy of these defaults; it imports nothing of the JAX
package.
"""

from typing import Any, Dict, Iterator, Tuple

_READ_NOWHERE = "read nowhere in the JAX package"

# key -> (JAX default, the ROADMAP item that would port it)
UNPORTED: Dict[str, Tuple[Any, str]] = {
    # the data-parallel mesh
    "TPU.MESH_AXES": (["data", "model"], "§A item 7"),
    "TPU.MESH_SHAPE": ([-1, 1], "§A item 7"),
}


def _stanza(prefix: str, defaults: Dict[str, Any], why: str) -> Dict[str, Tuple[Any, str]]:
    return {f"{prefix}.{k}": (v, why) for k, v in defaults.items()}


_REFERENCE_ONLY = _READ_NOWHERE + " (a stanza of the reference's config; the models fix these)"

# key -> (JAX default, why no value of it matters)
INERT: Dict[str, Tuple[Any, str]] = {
    "ENV_NAME": ("VLNCEDaggerEnv", _READ_NOWHERE),
    "SIMULATOR_GPU_ID": ([0], _READ_NOWHERE),
    "SENSORS": (["RGB_SENSOR", "DEPTH_SENSOR"],
                _READ_NOWHERE + " (TASK_CONFIG.SIMULATOR.AGENT_0.SENSORS sets the sensors)"),
    "TORCH_GPU_ID": (0, _READ_NOWHERE),
    "TPU.PARAM_DTYPE": ("float32", _READ_NOWHERE + " (parameters stay float32 in both)"),
    "TPU.USE_PALLAS": (True, _READ_NOWHERE + " (the LSTM kernel runs wherever it fits)"),
    "TPU.DONATE": (True, "donates the jitted step's buffers; eager PyTorch updates "
                         "parameters in place, and neither changes a value"),
    "MODEL.HIERARCHICAL": (True, _READ_NOWHERE + " (the trainer's name picks the family)"),
    "MODEL.ablate_sem_attn": (False, _REFERENCE_ONLY),
    "MODEL.VISUAL_LING_ATTN.fc_output": (512, _REFERENCE_ONLY),
    "MODEL.RGB_ENCODER.resnet_output_size": (256, _REFERENCE_ONLY),
    "MODEL.DEPTH_ENCODER.backbone": ("resnet50", _REFERENCE_ONLY),
    **_stanza("MODEL.TRANSFORMER_INSTRUCTION_ENCODER", dict(
        N=1, d_in=768, d_model=256, h=4, d_ff=1024, dropout=0.2, is_bert=True), _REFERENCE_ONLY),
    **_stanza("MODEL.IMAGE_CROSS_MODAL_ENCODER", dict(
        N=1, d_in=512, d_out=256, d_model=256, h=2, d_ff=1024, dropout=0.2), _REFERENCE_ONLY),
    **_stanza("MODEL.FLAT_AUX_LOSS", dict(use=False), _REFERENCE_ONLY),
    **_stanza("MODEL.LANG_ATTN", dict(use=False, hidden_size=512), _REFERENCE_ONLY),
    **_stanza("MODEL.SEM_ATTN_ENCODER", dict(use=False, hidden_size=512), _REFERENCE_ONLY),
    **_stanza("MODEL.SEM_TEXT_ATTN", dict(use=False, hidden_size=512), _REFERENCE_ONLY),
    **_stanza("MODEL.INTER_MODULE_ATTN", dict(
        N=1, in_features=512, fc_output=512, d_model=512, h=4, d_ff=1024, dropout=0.1),
        _REFERENCE_ONLY),
    **_stanza("MODEL.ACTION_DECODER_TRANFORMER", dict(
        N=1, in_features=512, fc_output=512, d_model=512, h=4, d_ff=1024, dropout=0.1),
        _REFERENCE_ONLY),
    **_stanza("MODEL.HYBRID_STATE_DECODER", dict(
        N=1, d_in=512, d_model=512, d_out=512, d_ff=1024, h=4, dropout=0.1, in_features=512,
        fc_output=512, RNN_output_size=512, hidden_size=512, rnn_type="LSTM",
        prev_action_embedding_dim=32), _REFERENCE_ONLY),
    **_stanza("MODEL.SEM_MAP_TRANSFORMER", dict(
        N=1, d_in=512, d_model=512, d_out=512, d_ff=1024, h=4, dropout=0.1, downsample_size=4,
        embedding_dim=64, layer_norm_eps=1e-12, n_output=512), _REFERENCE_ONLY),
    **_stanza("MODEL.TRANSFORMER", dict(
        use=False, output_size=512, use_prev_action=True, lr=1e-4, lr_drop=4,
        scheduler_patience=1e-4, split_gpus=False, hidden_size=512), _REFERENCE_ONLY),
    **_stanza("DDP", dict(distributed=False, world_size=1, rank=0, gpu=0, dist_url="env://",
                          dist_backend="nccl"),
              _READ_NOWHERE + " (the reference's DDP stanza; the mesh is §A item 7)"),
}


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def check_jax_only_keys(config) -> None:
    """Raise NotImplementedError for the first key of :data:`UNPORTED` that
    ``config`` sets to another value than the JAX default."""
    for key, value in _leaves(config):
        if key in UNPORTED and value != UNPORTED[key][0]:
            default, item = UNPORTED[key]
            raise NotImplementedError(
                f"{key} = {value!r}: the port does not read this key of the JAX package yet "
                f"and computes only its default {default!r} (ROADMAP {item})")
