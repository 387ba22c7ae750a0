"""MarginalNet: predicts the axis-marginal attention PDFs directly."""
