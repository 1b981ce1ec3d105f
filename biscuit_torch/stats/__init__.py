"""Host statistics of the port: sklearn-parity ROC/AUC/Youden (NumPy,
float64)."""

from .roc import (  # noqa: F401
    auc_and_youden,
    auc_score,
    roc_curve,
    trapezoid_auc,
    youden_threshold,
)
