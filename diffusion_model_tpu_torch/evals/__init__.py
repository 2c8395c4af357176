"""Evaluators of generated structures: RDF similarity, CN2 geometry and the
amorphous structure panel."""

from diffusion_model_tpu_torch.evals.amorphous import (
    aggregate_exo_rdf,
    bond_angle_samples,
    coordination_stats,
    envelope_matched_cloud,
    excess_rdf_cos,
    exo_rdf_resampling_ceiling,
    pair_distances,
    radial_envelope,
    structure_panel,
)
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
    "aggregate_exo_rdf",
    "bond_angle_samples",
    "coordination_stats",
    "envelope_matched_cloud",
    "excess_rdf_cos",
    "exo_rdf_resampling_ceiling",
    "pair_distances",
    "radial_envelope",
    "structure_panel",
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
