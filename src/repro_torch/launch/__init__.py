"""Entry points (`serve`)."""
