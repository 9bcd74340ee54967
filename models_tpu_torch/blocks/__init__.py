from .mlp import Dense, MLPBlock

__all__ = ["Dense", "MLPBlock"]
