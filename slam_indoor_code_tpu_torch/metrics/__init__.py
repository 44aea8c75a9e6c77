from .ate import absolute_trajectory_error, relative_pose_error, umeyama_alignment

__all__ = ["absolute_trajectory_error", "relative_pose_error", "umeyama_alignment"]
