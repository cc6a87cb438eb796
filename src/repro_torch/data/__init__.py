"""The training path's synthetic data pipeline (port of ``repro.data``)."""
