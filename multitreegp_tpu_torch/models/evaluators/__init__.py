from .sr import SREvaluator, generate_sr_data, sr_trajectories

__all__ = ["SREvaluator", "generate_sr_data", "sr_trajectories"]
