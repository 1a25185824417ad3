"""Parameter bridge from the JAX package and on-device random initialisation."""
