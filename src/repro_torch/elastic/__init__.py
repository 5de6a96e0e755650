"""Elastic re-meshing and straggler policy of the port (the counterpart of
``repro.elastic``)."""
from .elastic import (MeshPlan, shrink_mesh, ElasticPlan, plan_remesh,
                      StragglerPolicy, apply_straggler_policy,
                      renormalize_grads)

__all__ = ["MeshPlan", "shrink_mesh", "ElasticPlan", "plan_remesh",
           "StragglerPolicy", "apply_straggler_policy", "renormalize_grads"]
