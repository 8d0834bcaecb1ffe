"""The port's drivers of the study scripts: ``python -m
robo_vln_tpu_torch.scripts.<name>`` (convergence_study, probe_policy,
featurize_buffer)."""
