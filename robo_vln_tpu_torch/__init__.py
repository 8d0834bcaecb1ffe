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
"""

from .eval.agent import HCMAgent, build_hcm_agent

__all__ = ["HCMAgent", "build_hcm_agent"]
