"""Compute ops: image ingest, blur, pyramids, detection, description,
matching, and geometry — the XLA analogue of the reference's
C4-C12 component set."""
