"""Scene data model and pipeline logic."""
