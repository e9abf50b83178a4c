"""Entry points (`serve`, `train`)."""
