from .synthetic import make_regression_dataset

__all__ = ["make_regression_dataset"]
