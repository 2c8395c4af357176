"""Evaluators of generated structures: RDF similarity and CN2 geometry."""

from diffusion_model_tpu_torch.evals.cn2 import (
    aligned_group_means,
    cn2_statistics,
    conditional_angle_parity,
    conditional_bond_parity,
    filter_si_o_si,
    per_graph_group_means,
    r2score,
)
from diffusion_model_tpu_torch.evals.rdf import evaluate_rdf_lists, rdf_metrics

__all__ = [
    "aligned_group_means",
    "cn2_statistics",
    "conditional_angle_parity",
    "conditional_bond_parity",
    "evaluate_rdf_lists",
    "filter_si_o_si",
    "per_graph_group_means",
    "r2score",
    "rdf_metrics",
]
