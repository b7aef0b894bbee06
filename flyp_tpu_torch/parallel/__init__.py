"""Process-grid plumbing of the port (single-process half; the mesh, TP
and FSDP wait for ROADMAP A9)."""
