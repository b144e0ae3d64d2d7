"""The paper's own workload configuration: ridge cross-validation grids
for the piCholesky experiments (§6.3).

The JAX package's ``configs/picholesky.py``, the same numbers."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PiCholeskyConfig:
    h: int = 1024                 # feature dim + intercept (paper: up to 16384)
    n_train: int = 4096
    k_folds: int = 5
    n_lambdas: int = 31           # dense candidate grid (paper: 31)
    g_samples: int = 4            # sparse exact factorizations (paper: 4)
    degree: int = 2               # polynomial order (paper: 2)
    lam_lo: float = 1e-3
    lam_hi: float = 1.0
    block: int = 128              # packing/factorization tile
    mchol_s: float = 1.5
    mchol_s0: float = 0.0025


CONFIG = PiCholeskyConfig()
