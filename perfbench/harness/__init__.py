"""The benchmark's harness: everything but the data files, the references,
the roofline counts and the per-layer readers, which it finds by name."""
