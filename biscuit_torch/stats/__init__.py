"""Host statistics of the port (ROC, AUC, Youden)."""
