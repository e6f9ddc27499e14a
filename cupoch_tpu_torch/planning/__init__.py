"""Path planning: the roadmap planner over a 3D position graph."""
from .planner import PlannerBase, Pos3DPlanner

__all__ = ["PlannerBase", "Pos3DPlanner"]
