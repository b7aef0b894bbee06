"""Host-side data helpers of the serving path: eval preprocessing and
packaged class names."""
