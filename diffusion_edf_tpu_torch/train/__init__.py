"""Training (the trainer, its optimizer, augmentation, ranking loss, demo data and command line), config loading, host-side preprocessing and the model factory."""
