"""Closed-loop checkpoint evaluation of the hierarchical (HCM) agent and of
the flat family (counterpart of the host rollout loops of
robo_vln_tpu/eval/evaluator.py).

30 Hz alternation of the policy tick with a host-side sim step, per-episode
nDTW against the ground-truth locations, and the aggregated stats JSON and
scalars.  The tick is :meth:`eval.agent.HCMAgent.act`
(:func:`eval_hierarchical_checkpoint`: the trainer's loaded ``high`` and
``low``, the shared frozen trunks, both LSTM kernels and both attention
launches) or :meth:`eval.agent.FlatAgent.act`
(:func:`eval_flat_checkpoint`: the trainer's CMA or Seq2Seq policy, its
state encoders' LSTM kernel).  :func:`_run_rollout` drives
``EVAL.NUM_ENVS`` envs (one included) with one tick over the batch.

Per tick the host sends the observations to the device and fetches the
actions and the stop logit back in ONE copy; the agent caches the frozen
BERT embedding, or the flat policy's instruction encoding, on the host's
view of the token ids (re-embedded whenever any env's ids change), so the
device compares nothing.

Preserved reference quirks:
* omega clipped to +/-1.0 at actuation (robo_vln_trainer.py:1117-1119);
* ``episode_success = success and (lin_vel < 0.25 or stop_pred == 1)`` uses
  the RAW lin_vel output — negative when driving forward — so the velocity
  gate is almost always open (:1123-1125); kept as-is for parity;
* hidden/prev/masks reset to zeros on episode end (:1211-1222); per env in
  the batched loop.

``EVAL.ON_DEVICE`` on the kinematic backend runs :func:`_eval_on_device`
instead: the whole rollout on the device (eval/ondevice.py), a CUDA graph of
the tick replayed on the card, the same stats JSON and trajectory dump.

The single-env driver's extras, as in the JAX package, at ``EVAL.NUM_ENVS``
1 only (more envs warn and make none):

* ``VIDEO_OPTION``: a frame a step (rgb, depth and, with the
  ``TOP_DOWN_MAP`` measure, the map tile; the instruction below), the
  previous step's frame assembled while the device runs the policy, and a
  video an episode (tasks/viz.generate_video); the map stays out of the
  stats;
* ``PLOT_ATTENTION`` (the HCM agent): each tick's instruction-token
  salience, computed on the device (eval/agent.HCMAgent.salience), copied
  to the host at the episode's end and written as a heatmap PNG under
  ``VIDEO_DIR/attention/`` (tasks/viz.save_attention_plot).

The nonlearning agents' eval is agents/nonlearning.py.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Callable, Dict, List

import numpy as np
import torch

from ..envs.async_env import AsyncEnvPool
from ..envs.env_utils import construct_envs
from ..envs.obs_utils import batch_obs, make_tokenizer, transform_obs
from ..envs.velocity_control import VelocityControl
from ..tasks.dtw import ndtw
from ..training import checkpoint as ckpt_lib
from ..utils.logging import logger
from .agent import FlatAgent, HCMAgent


def _load_gt(config):
    split = config.TASK_CONFIG.DATASET.SPLIT
    path = config.TASK_CONFIG.TASK.NDTW.GT_PATH.format(split=split)
    if os.path.exists(path):
        with gzip.open(path, "rt") as f:
            return json.load(f)
    return {}


def _policy_obs(config, observations, tokenizer, is_bert, instr_cache,
                episode_id):
    obs = dict(observations)
    uuid = config.TASK_CONFIG.TASK.INSTRUCTION_SENSOR_UUID
    if episode_id in instr_cache:
        obs[uuid] = instr_cache[episode_id]
    else:
        obs = transform_obs(obs, uuid, tokenizer=tokenizer, is_bert=is_bert)
        instr_cache.clear()  # one episode in flight; don't grow unboundedly
        instr_cache[episode_id] = obs[uuid]
    keep = ("rgb", "depth", uuid, "progress")
    obs = {k: v for k, v in obs.items() if k in keep}
    return batch_obs(obs, pad_instruction_to=config.DAGGER.MAX_INSTRUCTION_LEN)


def _aggregate_and_log(stats_episodes, config, writer, checkpoint_index,
                       extra_fields: Dict = None):
    aggregated = {}
    num = len(stats_episodes)
    for key in next(iter(stats_episodes.values())).keys():
        vals = [v[key] for v in stats_episodes.values() if v[key] is not None]
        aggregated[key] = float(np.mean(vals)) if vals else 0.0
    split = config.TASK_CONFIG.DATASET.SPLIT
    os.makedirs(config.EVAL.VAL_LOG_DIR, exist_ok=True)
    out = os.path.join(
        config.EVAL.VAL_LOG_DIR, f"stats_ckpt_{checkpoint_index}_{split}.json"
    )
    logger.info(f"Episodes evaluated: {num}")
    for k, v in aggregated.items():
        logger.info(f"Average episode {k}: {v:.6f}")
        writer.add_scalar(f"eval_{split}_{k}", v, checkpoint_index + 1)
    if extra_fields:
        # non-scalar payload (backbone provenance) recorded in the stats json
        # but never aggregated or written as scalars
        aggregated = {**aggregated, **extra_fields}
    with open(out, "w") as f:
        json.dump(aggregated, f, indent=4)
    return aggregated


# settings that belong to the EVAL INVOCATION, reapplied after a
# USE_CKPT_CONFIG restore (the reference does the same via _setup_eval_config
# + the explicit SPLIT overrides, robo_vln_trainer.py:1008-1022); DEVICE is
# the port's: a checkpoint trained on the card evaluates where it is asked to
_EVAL_SIDE_KEYS = (
    "EVAL", "EVAL_CKPT_PATH_DIR", "VIDEO_OPTION", "VIDEO_DIR", "TENSORBOARD_DIR",
    "LOG_FILE", "PLOT_ATTENTION", "NUM_PROCESSES", "DEVICE",
)


def _reference_checkpoint_config(path: str):
    """The training config stored in a reference ``.pth``, when it is a
    plain dict (read with ``weights_only=True``: a pickled yacs CfgNode is
    refused, and the eval config is used)."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # noqa: BLE001 — a pickled config, a truncated file
        logger.warning(f"could not read config from {path}: {e}")
        return None
    cfg = ckpt.get("config") if isinstance(ckpt, dict) else None
    return dict(cfg) if isinstance(cfg, dict) else None


def _eval_config(trainer, checkpoint_path: str = ""):
    config = trainer.config.clone().defrost()
    if config.EVAL.USE_CKPT_CONFIG and checkpoint_path:
        # restore the FULL training-time config stored with the checkpoint
        # (reference EVAL.USE_CKPT_CONFIG, robo_vln_trainer.py:1008-1011 —
        # task/dagger settings like instruction length and sensor sizes come
        # from training, not from the eval yaml), then reapply the eval-side
        # invocation settings
        cp = str(checkpoint_path)
        saved = None
        if cp.endswith(".pth") and os.path.isfile(cp):
            raw = _reference_checkpoint_config(cp)
            if raw:
                # reference configs carry habitat task trees that do not map
                # onto this framework's backends; restore the stanzas that do
                saved = {k: raw[k] for k in ("MODEL", "DAGGER") if k in raw}
        else:
            meta = ckpt_lib.load_metadata(cp)
            if meta:
                saved = meta.get("config", {})
        if saved:
            try:
                config.merge_dict(saved)
            except Exception as e:  # noqa: BLE001 — keep the eval config
                logger.warning(
                    f"USE_CKPT_CONFIG: saved config did not merge cleanly "
                    f"({e}); continuing with the eval config"
                )
                config = trainer.config.clone().defrost()
            for k in _EVAL_SIDE_KEYS:
                v = trainer.config.get(k)
                config[k] = v.clone() if hasattr(v, "clone") else v
    config.TASK_CONFIG.DATASET.SPLIT = config.EVAL.SPLIT
    config.TASK_CONFIG.TASK.NDTW.SPLIT = config.EVAL.SPLIT
    config.TASK_CONFIG.TASK.SDTW.SPLIT = config.EVAL.SPLIT
    config.freeze()
    return config


def _load_eval_weights(trainer, checkpoint_path) -> None:
    """Load eval weights into a set-up trainer, hierarchical or flat (it
    holds a ``policy``): a reference ``.pth``
    (``training/checkpoint.load_reference_checkpoint`` or
    ``load_reference_flat_checkpoint``) or a port checkpoint directory
    (``train_state.pt`` + ``framework_metadata.json``).  A path that does
    not exist leaves the weights as they are, as in the JAX package; any
    other path raises, an orbax directory of the JAX package among them
    (scripts/jax_checkpoint_to_torch.py converts one where JAX is
    installed)."""
    cp = str(checkpoint_path)
    if not (checkpoint_path and os.path.exists(cp)):
        return
    flat = getattr(trainer, "policy", None) is not None
    if cp.endswith(".pth"):
        if flat:
            ckpt_lib.load_reference_flat_checkpoint(trainer, cp)
        else:
            ckpt_lib.load_reference_checkpoint(trainer, cp)
        # trunks now come from the checkpoint, whatever the set-up found
        trainer.pretrained_backbones = {
            k: {"status": "checkpoint", "path": cp}
            for k, v in getattr(trainer, "pretrained_backbones", {}).items()
            if v.get("status") != "not_in_model"
        }
    elif os.path.isfile(os.path.join(cp, ckpt_lib.TRAIN_STATE)):
        if flat:
            trainer.state = ckpt_lib.load_flat_checkpoint(cp, trainer.policy, trainer.state)
        else:
            trainer.state = ckpt_lib.load_checkpoint(cp, trainer.high, trainer.low,
                                                     trainer.state)
    else:
        raise ValueError(
            f"{cp} is not a checkpoint the port reads: it reads a port checkpoint "
            f"directory ({ckpt_lib.TRAIN_STATE} + {ckpt_lib.METADATA}) and a reference "
            ".pth; convert a JAX package (orbax) checkpoint with "
            "scripts/jax_checkpoint_to_torch.py on a machine with JAX")
    logger.info(f"Loaded weights from checkpoint: {checkpoint_path}")


def _check_backbone_provenance(trainer) -> Dict:
    """Warn (loudly) when an eval is about to run with RANDOM frozen trunks:
    it produces plausible-looking but meaningless stats.  Returns the
    provenance dict for the stats json."""
    prov = getattr(trainer, "pretrained_backbones", {}) or {}
    missing = [k for k, v in prov.items()
               if v.get("status") in ("missing_file", "error")]
    if missing:
        logger.warning(
            "EVAL WITH RANDOM BACKBONES: no pretrained weights were loaded "
            f"for {missing} — metrics will be meaningless."
        )
    return prov


def shuffle_instructions(episodes, label: str = "eval") -> int:
    """EVAL.SHUFFLE_INSTRUCTIONS language-grounding control: give every
    episode a DIFFERENT episode's instruction — a deterministic rotation in
    episode_id order, which is a derangement whenever the instructions are
    pairwise distinct — while the start pose, reference path, goals, and all
    metrics stay the episode's own.  A policy that grounds language must
    collapse toward a nonlearning baseline under this control; a policy
    that memorized a path prior is unaffected.  Returns the number of
    episodes whose instruction actually changed."""
    order = sorted(range(len(episodes)),
                   key=lambda i: str(episodes[i].episode_id))
    if len(order) < 2:
        logger.warning(
            f"{label}: SHUFFLE_INSTRUCTIONS with <2 episodes is a no-op"
        )
        return 0
    instrs = [episodes[i].instruction for i in order]
    changed = 0
    for k, i in enumerate(order):
        new = instrs[(k + 1) % len(order)]
        if new.instruction_text != episodes[i].instruction.instruction_text:
            changed += 1
        episodes[i].instruction = new
    logger.info(
        f"{label}: SHUFFLE_INSTRUCTIONS control active — {changed}/"
        f"{len(order)} episodes now carry another episode's instruction"
    )
    return changed


def _maybe_shuffle_env_instructions(config, envs) -> None:
    if not config.EVAL.SHUFFLE_INSTRUCTIONS:
        return
    for env in envs:
        ds = getattr(env, "dataset", None)
        if ds is not None and getattr(ds, "episodes", None):
            shuffle_instructions(ds.episodes)


def _episode_budget(config, envs) -> int:
    """Cap on completed episodes: requesting more episodes than the dataset
    holds must terminate, not spin on repeated ids forever (the stats dict is
    keyed by episode_id).  Counts UNIQUE episode ids across the envs —
    scene-split fallbacks can hand several envs the same episodes.  Envs
    without an introspectable dataset return the raw count; the rollout
    loops also carry a duplicate-completion circuit breaker for that case."""
    unique = set()
    introspectable = True
    for env in envs:
        ds = getattr(env, "dataset", None)
        if ds is None:
            introspectable = False
            continue
        unique |= {ep.episode_id for ep in ds.episodes}
    want = config.EVAL.EPISODE_COUNT
    if introspectable and unique and len(unique) < want:
        logger.warning(
            f"EVAL.EPISODE_COUNT={want} exceeds the {len(unique)} unique "
            "episodes available; evaluating each episode once"
        )
        return len(unique)
    return want


class _DuplicateBreaker:
    """Terminates an id-keyed eval loop when completions stop yielding new
    episodes (backstop for envs whose dataset size is unknown)."""

    def __init__(self, label: str = "eval"):
        self._consecutive = 0
        self._label = label

    def record(self, was_new: bool, n_unique: int) -> bool:
        """Returns True when the loop should stop."""
        self._consecutive = 0 if was_new else self._consecutive + 1
        if self._consecutive > max(2 * n_unique + 10, 20):
            logger.warning(
                f"{self._label}: {self._consecutive} consecutive repeated "
                f"episodes after {n_unique} unique — dataset exhausted, "
                "stopping"
            )
            return True
        return False


def _dump_trajectory(config, writer, checkpoint_index, episode, locations,
                     stats) -> None:
    """EVAL.DUMP_TRAJECTORIES: append this episode's position trace to
    <writer.log_dir>/trajectories.jsonl, in the JAX package's format."""
    if not config.EVAL.DUMP_TRAJECTORIES:
        return
    log_dir = getattr(writer, "log_dir", None)
    if not log_dir:
        return
    row = {
        "episode_id": str(episode.episode_id),
        "ckpt_index": int(checkpoint_index),
        "success": float(stats.get("success", 0.0) or 0.0),
        "actual_success": float(stats.get("actual_success", 0.0) or 0.0),
        "ndtw": float(stats.get("ndtw", 0.0) or 0.0),
        "steps": len(locations),
        "locations": [[round(float(x), 5) for x in p] for p in locations],
    }
    with open(os.path.join(log_dir, "trajectories.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")


def _episode_stats(info, locations, gt_json, ep, sd, episode_success) -> Dict:
    gt_locations = gt_json.get(str(ep.episode_id), {}).get(
        "locations", list(ep.reference_path) + [ep.goals[0].position]
    )
    # the map is a frame payload, not a scalar metric
    stats = {k: v for k, v in info.items() if k != "top_down_map"}
    stats["ndtw"] = ndtw(locations, gt_locations, sd)
    stats["actual_success"] = 1.0 if episode_success else 0.0
    return stats


def _stop_pred(stop_logit: float) -> float:
    return float(np.round(1 / (1 + np.exp(-stop_logit))))


def _stack_obs(obs_list):
    return {k: np.concatenate([o[k] for o in obs_list], axis=0) for k in obs_list[0]}


def _run_rollout(config, envs, writer, checkpoint_index: int, policy_step: Callable,
                 init_state: Callable, tokenizer, is_bert: bool,
                 extra_fields: Dict = None,
                 on_episode_end: Callable = None) -> Dict[str, float]:
    """``EVAL.NUM_ENVS`` envs, one of them included: policy tick over the
    env batch / sim tick alternation, per-episode stats, aggregation.
    ``policy_step(obs, state, reset_rows, while_running=...)`` returns the
    actions and stop logit on the host, (N, 3), and the new state, and calls
    ``while_running()`` (when not None) between launching the policy and
    reading its output.  At one env, ``VIDEO_OPTION`` makes a video an
    episode, and ``on_episode_end(episode)`` runs after each episode's
    stats are recorded.  An env's episode reset
    zeroes its row of the mask and of prev (and so of the LSTM states): a
    fresh episode's first tick runs with mask_i = 0, as in both of the JAX
    package's loops.  At one env this is the JAX single-env loop but for
    one case: an episode completed again (only an env whose dataset the
    budget cannot count repeats one) keeps its first stats and trajectory,
    where the single-env loop records it again."""
    gt_json = _load_gt(config)
    n = len(envs)
    pool = AsyncEnvPool(envs)
    sd = config.TASK_CONFIG.TASK.NDTW.SUCCESS_DISTANCE
    max_steps = config.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS

    instr_caches = [dict() for _ in range(n)]
    obs_list = pool.reset()
    eps = [e.current_episode for e in envs]
    per_obs = [
        _policy_obs(config, o, tokenizer, is_bert, c, ep.episode_id)
        for o, c, ep in zip(obs_list, instr_caches, eps)
    ]
    state = init_state(n)
    reset_rows: List[int] = list(range(n))
    vcs = [VelocityControl() for _ in range(n)]

    episode_budget = _episode_budget(config, envs)
    breaker = _DuplicateBreaker("eval")
    stop_loop = False
    stats_episodes: Dict = {}
    locations = [[] for _ in range(n)]
    steps = [0] * n

    video = bool(config.VIDEO_OPTION) and n == 1
    if config.VIDEO_OPTION and not video:
        logger.warning("VIDEO_OPTION is only rendered by the single-env driver; "
                       "EVAL.NUM_ENVS>1 produces no videos")
    frames: List[np.ndarray] = []
    pending = None  # the last step's (observations, info, instruction) to draw

    def assemble_pending():
        nonlocal pending
        if pending is None:
            return
        from ..tasks.viz import append_text_to_image, observations_to_image

        f_obs, f_info, text = pending
        frames.append(append_text_to_image(observations_to_image(f_obs, f_info), text))
        pending = None

    while len(stats_episodes) < episode_budget:
        for i, env in enumerate(envs):
            locations[i].append(list(env.get_agent_position()))
        # the device runs the tick while the host draws the last step's frame
        out, state = policy_step(_stack_obs(per_obs), state, reset_rows,
                                 while_running=assemble_pending if video else None)
        for i in range(n):
            vcs[i].linear_velocity = np.array([0.0, 0.0, float(out[i, 0])])
            vcs[i].angular_velocity = np.array(
                [0.0, float(np.clip(out[i, 1], -1.0, 1.0)), 0.0]
            )
        pool.async_step(vcs)
        reset_rows = []
        results = pool.wait_step()

        for i, (observations, _, done, info) in enumerate(results):
            episode_over, success = done
            lin_vel = float(out[i, 0])
            episode_success = success and (lin_vel < 0.25 or _stop_pred(float(out[i, 2])) == 1)
            steps[i] += 1
            if video:
                pending = (observations, info, eps[i].instruction.instruction_text)
            if episode_over or episode_success or steps[i] == max_steps:
                ep = eps[i]
                was_new = ep.episode_id not in stats_episodes
                stats = stats_episodes.get(ep.episode_id)
                if was_new:
                    stats = _episode_stats(info, locations[i], gt_json, ep, sd,
                                           episode_success)
                    stats_episodes[ep.episode_id] = stats
                    _dump_trajectory(
                        config, writer, checkpoint_index, ep,
                        locations[i] + [list(envs[i].get_agent_position())], stats,
                    )
                if breaker.record(was_new, len(stats_episodes)):
                    stop_loop = True
                elif video:
                    from ..tasks.viz import generate_video

                    assemble_pending()
                    generate_video(list(config.VIDEO_OPTION), config.VIDEO_DIR, frames,
                                   ep.episode_id, checkpoint_index,
                                   {"SPL": round(stats.get("spl") or 0.0, 6)}, writer,
                                   fps=int(1.0 / config.DAGGER.time_step))
                    frames = []
                if on_episode_end is not None and not stop_loop:
                    on_episode_end(ep)
                observations = pool.reset_at(i)
                eps[i] = envs[i].current_episode
                locations[i] = []
                steps[i] = 0
                reset_rows.append(i)
            per_obs[i] = _policy_obs(
                config, observations, tokenizer, is_bert, instr_caches[i],
                eps[i].episode_id,
            )
        if stop_loop:
            break

    pool.close()
    return _aggregate_and_log(stats_episodes, config, writer, checkpoint_index,
                              extra_fields)


class _PolicyTick:
    """The host side of an agent's ``act`` (:class:`HCMAgent`,
    :class:`FlatAgent`): numpy observations to the
    agent's device, the mask and prev (zeroed in the rows of envs whose
    episode just began), the host's token ids for the agent's BERT cache
    (re-embedded whenever any env's ids change), and the actions and stop
    logit back in one device-to-host copy.  ``while_running`` runs on the
    host after the tick is queued and before that copy waits for it."""

    def __init__(self, agent):
        self.agent = agent
        self.device = agent.device
        self._prev = None

    def __call__(self, obs: Dict[str, np.ndarray], state, reset_rows,
                 while_running: Callable = None):
        dev = {k: torch.from_numpy(v).to(self.device) for k, v in obs.items()}
        b = obs["instruction"].shape[0]
        mask = torch.ones(b, device=self.device)
        prev = self._prev
        if prev is None or prev.shape[0] != b:
            prev = torch.zeros(b, 2, device=self.device)
        if reset_rows:
            rows = torch.tensor(reset_rows, device=self.device)
            mask[rows] = 0.0
            prev = prev.index_fill(0, rows, 0.0)
        actions, stop, state = self.agent.act(dev, state, prev, mask,
                                              host_ids=obs["instruction"])
        self._prev = actions
        if while_running is not None:  # host work beside the queued tick
            while_running()
        return torch.cat([actions, stop], dim=1).cpu().numpy(), state


def _eval_on_device(config, writer, checkpoint_index: int, extra, policy_step,
                    init_hidden: Callable, embed: Callable, device) -> Dict[str, float]:
    """EVAL.ON_DEVICE: the episodes in batches of ``EVAL.ON_DEVICE_BATCH``,
    each rolled out whole on the device (eval/ondevice.Rollout), the last
    batch padded with its final episode so that the graph keeps its shape.
    ``embed(ids (B, L) numpy)`` is the instruction's embedding on the device
    (BERT's (B, L, D) for the HCM agent, the flat policy's instruction
    encoding), run once a batch outside the graph.  The same stats JSON and
    trajectory dump as the host driver."""
    from ..data.dataset import VLNCEDatasetV1
    from . import ondevice

    dataset = VLNCEDatasetV1(config=config.TASK_CONFIG.DATASET)
    episodes = dataset.episodes[:min(config.EVAL.EPISODE_COUNT, len(dataset.episodes))]
    if config.EVAL.SHUFFLE_INSTRUCTIONS:
        shuffle_instructions(episodes, label="on-device eval")
    gt_json = _load_gt(config)
    sd = config.TASK_CONFIG.TASK.NDTW.SUCCESS_DISTANCE
    tokenizer, is_bert = make_tokenizer(config), config.MODEL.INSTRUCTION_ENCODER.is_bert
    L = config.DAGGER.MAX_INSTRUCTION_LEN
    bs = int(config.EVAL.ON_DEVICE_BATCH)
    k_points = max(len(ep.reference_path) + 1 for ep in episodes)
    rollout = ondevice.Rollout(policy_step, config, bs, init_hidden(bs), device)

    def instruction_ids(ep):
        obs = transform_obs(
            {"instruction": {"text": ep.instruction.instruction_text,
                             "tokens": ep.instruction.instruction_tokens or []}},
            "instruction", tokenizer=tokenizer, is_bert=is_bert)
        ids = np.zeros((L,), np.int32)
        raw = np.asarray(obs["instruction"]).reshape(-1)[:L]
        ids[:len(raw)] = raw
        return ids

    stats_episodes: Dict = {}
    for s in range(0, len(episodes), bs):
        chunk = episodes[s:s + bs]
        padded = chunk + [chunk[-1]] * (bs - len(chunk))
        ids = np.stack([instruction_ids(ep) for ep in padded])
        rollout.load(ondevice.pack_episodes(padded, k_points), ids, embed(ids))
        result = rollout.run()
        for i, ep in enumerate(chunk):
            stats = ondevice.episode_stats(result, ep, i, gt_json, sd)
            stats_episodes[ep.episode_id] = stats
            # the trace the stats were computed from: the start, then each
            # tick's post-step position
            n_steps = int(result["steps"][i])
            trace = [list(map(float, np.asarray(ep.start_position)))] + [
                list(map(float, p)) for p in result["positions"][:max(n_steps, 1), i]]
            _dump_trajectory(config, writer, checkpoint_index, ep, trace, stats)
        batch = rollout.batches[-1]
        logger.info(f"on-device eval: {len(stats_episodes)}/{len(episodes)} episodes "
                    f"({result['n_ticks']} ticks for this batch, {batch['replays']} "
                    f"replays of {rollout.graph_ticks} ticks, {batch['syncs']} host syncs)")
    if rollout.capture_ms is not None:
        logger.info(f"on-device eval: captured {rollout.graph_ticks} ticks in "
                    f"{rollout.capture_ms:.1f} ms, launches a graph {rollout.graph_launches}")
    return _aggregate_and_log(stats_episodes, config, writer, checkpoint_index, extra)


def _eval_hier_on_device(trainer, config, writer, checkpoint_index: int,
                         extra) -> Dict[str, float]:
    """The HCM agent's tick (:meth:`HCMAgent.step`: the shared trunks, both
    levels, both kernels) and its BERT for :func:`_eval_on_device`."""
    agent = HCMAgent(trainer.high, trainer.low,
                     share_frozen_trunks=config.TPU.SHARE_FROZEN_TRUNKS)

    def embed(ids):
        return agent.embed_instruction(torch.from_numpy(ids).to(agent.device), ids)

    stats = _eval_on_device(config, writer, checkpoint_index, extra, agent.step,
                            agent.initial_state, embed, agent.device)
    logger.info(f"BERT embedded the instructions {agent.embeds} times")
    return stats


def eval_hierarchical_checkpoint(trainer, checkpoint_path, writer,
                                 checkpoint_index: int = 0) -> Dict[str, float]:
    config = _eval_config(trainer, checkpoint_path)
    n_envs = config.EVAL.NUM_ENVS

    if trainer.high is None:
        trainer._setup_policy()
    _load_eval_weights(trainer, checkpoint_path)
    provenance = _check_backbone_provenance(trainer)
    extra = {"pretrained_backbones": provenance} if provenance else None

    if config.EVAL.ON_DEVICE:
        if config.TASK_CONFIG.SIMULATOR.TYPE == "kinematic":
            return _eval_hier_on_device(trainer, config, writer, checkpoint_index, extra)
        logger.warning(
            "EVAL.ON_DEVICE needs the kinematic backend "
            f"(SIMULATOR.TYPE={config.TASK_CONFIG.SIMULATOR.TYPE!r}); "
            "running the host driver")

    envs = construct_envs(config, num_envs=n_envs)
    _maybe_shuffle_env_instructions(config, envs)
    # checked after the weights are loaded: the shared frozen-trunk pass runs
    # only when both policies' trunks are bitwise identical
    agent = HCMAgent(trainer.high, trainer.low,
                     share_frozen_trunks=config.TPU.SHARE_FROZEN_TRUNKS)
    tick = _PolicyTick(agent)
    tokenizer, is_bert = make_tokenizer(config), config.MODEL.INSTRUCTION_ENCODER.is_bert
    # PLOT_ATTENTION (reference config/default.py:27): each tick's salience
    # kept on the device, a heatmap PNG an episode
    plot_attention = bool(config.PLOT_ATTENTION) and n_envs == 1
    if config.PLOT_ATTENTION and not plot_attention:
        logger.warning("PLOT_ATTENTION is only rendered by the single-env driver; "
                       "EVAL.NUM_ENVS>1 produces no attention heatmaps")
    on_episode_end = None
    if plot_attention:
        salience: List[torch.Tensor] = []
        plain_tick = tick

        def tick(*args, **kwargs):
            out = plain_tick(*args, **kwargs)
            salience.append(agent.salience)
            return out

        def on_episode_end(ep):
            if salience:
                from ..tasks.viz import save_attention_plot

                save_attention_plot(torch.cat(salience).cpu().numpy(), ep.episode_id,
                                    config.VIDEO_DIR, checkpoint_index)
                salience.clear()

    from ..ops import cm_attention

    cm_attention.set_sow_attention(plot_attention)
    try:
        stats = _run_rollout(config, envs, writer, checkpoint_index, tick,
                             agent.initial_state, tokenizer, is_bert, extra, on_episode_end)
    finally:
        cm_attention.set_sow_attention(False)
    logger.info(f"BERT embedded the instructions {agent.embeds} times")
    return stats


def _eval_flat_on_device(agent: FlatAgent, config, writer, checkpoint_index: int,
                         extra) -> Dict[str, float]:
    """The flat policy's tick (:meth:`FlatAgent.step`: its encoders and
    state encoders, the LSTM kernel) for :func:`_eval_on_device`; the
    instruction encoder runs once a batch outside the graph, through the
    ``embed`` hook, and its output rides in ``instruction_embedding``."""

    def embed(ids):
        return agent.embed_instruction(torch.from_numpy(ids).to(agent.device), ids)

    stats = _eval_on_device(config, writer, checkpoint_index, extra, agent.step,
                            agent.initial_state, embed, agent.device)
    logger.info(f"the instruction encoder ran {agent.embeds} times")
    return stats


def eval_flat_checkpoint(trainer, checkpoint_path, writer,
                         checkpoint_index: int = 0) -> Dict[str, float]:
    """Evaluate a flat checkpoint (a port ``ckpt.{N}/`` or a reference
    ``.pth``) with RoboVLNTrainer's policy: the host driver over
    ``EVAL.NUM_ENVS`` envs, or with ``EVAL.ON_DEVICE`` on the kinematic
    backend the whole rollout on the device."""
    config = _eval_config(trainer, checkpoint_path)
    if trainer.policy is None:
        trainer._setup_policy()
    _load_eval_weights(trainer, checkpoint_path)
    provenance = _check_backbone_provenance(trainer)
    extra = {"pretrained_backbones": provenance} if provenance else None
    agent = FlatAgent(trainer.policy)

    if config.EVAL.ON_DEVICE:
        if config.TASK_CONFIG.SIMULATOR.TYPE == "kinematic":
            return _eval_flat_on_device(agent, config, writer, checkpoint_index, extra)
        logger.warning(
            "EVAL.ON_DEVICE needs the kinematic backend "
            f"(SIMULATOR.TYPE={config.TASK_CONFIG.SIMULATOR.TYPE!r}); "
            "running the host driver")

    envs = construct_envs(config, num_envs=config.EVAL.NUM_ENVS)
    _maybe_shuffle_env_instructions(config, envs)
    tokenizer, is_bert = make_tokenizer(config), config.MODEL.INSTRUCTION_ENCODER.is_bert
    stats = _run_rollout(config, envs, writer, checkpoint_index, _PolicyTick(agent),
                         agent.initial_state, tokenizer, is_bert, extra)
    logger.info(f"the instruction encoder ran {agent.embeds} times")
    return stats
