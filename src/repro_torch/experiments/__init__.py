"""The reproduction pipeline (``detection_repro``): trained detectors, their
matched outputs and the fitted engine."""
