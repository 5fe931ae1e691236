"""The harness core: manifest, inputs, trace reduction, counts, the run."""
