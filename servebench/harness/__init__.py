"""The serving benchmark of ``repro_torch``: the yardstick's own code.

Everything that decides what a run measures lives here and nowhere in
the program: the traffic generator (:mod:`.traffic`), the percentile and
spread arithmetic (:mod:`.stats`), the operation and byte counts and the
H100's peaks (:mod:`.cost`), the seeded weights (:mod:`.weights`), the
plain float32 reference and its lower-precision control
(:mod:`.reference`), the hooks at the program's boundaries
(:mod:`.hooks`), the reading of the profiler's trace (:mod:`.trace`),
the comparison that decides ``correct`` (:mod:`.check`) and one run of a
cell (:mod:`.run_cell`).  None of it imports JAX or the JAX package.
"""
