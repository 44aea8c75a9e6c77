from .synthetic import SyntheticScene, make_scene

__all__ = ["SyntheticScene", "make_scene"]
