"""Learned priors of the data-driven mode: the GMM pose prior, the PCA pose
model and the windowed linear AR motion model, and their training data."""
