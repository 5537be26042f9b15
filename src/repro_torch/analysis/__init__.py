"""Program analysis of the port's workloads without running them on a
card: the roofline (``roofline``), the traced-program counter
(``counter``) and the hand-written kernels' cost formulas
(``kernel_costs``)."""
