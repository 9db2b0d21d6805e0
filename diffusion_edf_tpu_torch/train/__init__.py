"""Config loading, host-side preprocessing and the model factory."""
