"""End-to-end experiments reproducing the paper's tables/figures
(``detection_repro``): trained detectors, their matched outputs, the fitted
engine, and every figure and table with ``run_all``."""
