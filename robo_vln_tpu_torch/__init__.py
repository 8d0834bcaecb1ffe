"""PyTorch + CUDA port of robo_vln_tpu's HCM agent, for one NVIDIA H100.

The serving path of the hierarchical cross-modal agent: frozen BERT, the
two frozen ResNet50 trunks, VisualLingAttn and both policies' LSTMs.  The
two TPU kernels of that path are hand-written CUDA C++ for sm_90a
(``csrc/``): the fused LSTM recurrence and the cross-modal attention.  This
package imports torch and nothing of JAX or of robo_vln_tpu.

    from robo_vln_tpu_torch import build_hcm_agent
    from robo_vln_tpu_torch.config import get_config
    agent = build_hcm_agent(get_config().MODEL)          # on the card
    actions, stop, state = agent.act(obs, agent.initial_state(b), None, mask)

The names below load eval/agent.py (and torch) on first use, so that a
host-only module such as envs/collection.py, which collection's spawned
workers import, loads no torch.
"""

__all__ = ["HCMAgent", "build_hcm_agent"]


def __getattr__(name):
    if name in __all__:
        from .eval import agent

        return getattr(agent, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
