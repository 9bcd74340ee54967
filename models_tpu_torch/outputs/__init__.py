from .topk import BruteForce, TopKOutput

__all__ = ["BruteForce", "TopKOutput"]
