from .synthetic import cross_source, make_low_rank_dataset, \
    make_regression_dataset, token_stream

__all__ = ["make_regression_dataset", "make_low_rank_dataset", "token_stream",
           "cross_source"]
