"""One driver per traffic kind (the ``kind`` of a mix's file): set-up, the
measured window, the traced sub-window and the check of the outputs."""
