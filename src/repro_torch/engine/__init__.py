"""Layer-plan engine: `plan` decides once offline, `execute` routes."""
