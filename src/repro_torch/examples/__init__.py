"""The JAX package's six examples (``examples/*.py``) on the port, each a
module with the reference's flags plus ``--device`` (the CUDA device unless
given; ``--device cpu`` runs the plain versions), printing the reference's
lines and returning from ``main(argv=None)`` the numbers it printed:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.ridge_cv [--h 512] \\
        [--n 1500] [--mesh] [--tune] [--search] [--sketch] [--precision P]
    PYTHONPATH=src python -m repro_torch.examples.serve_cv --requests 24
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch \\
        recurrentgemma-2b --tokens 16
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 50
    PYTHONPATH=src python -m repro_torch.examples.lm_probe --arch smollm-360m

Random draws come from ``torch.Generator`` (``jax.random`` cannot be
reproduced); each example's inner ``run`` takes the arrays or weights a
caller hands it as keyword arguments instead.
"""
