"""Operations and bytes from shapes: the model FLOPs of a train step or a
served batch (:mod:`portbench.work.model`), the operations and bytes of the
port's kernel calls (:mod:`portbench.work.calls`), and the H100's published
peaks (:mod:`portbench.work.peaks`)."""
