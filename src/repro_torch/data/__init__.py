from .synthetic import make_low_rank_dataset, make_regression_dataset

__all__ = ["make_regression_dataset", "make_low_rank_dataset"]
