"""icp_iterations_per_frame (iterations/frame, program counter): the ICP
iterations of the traced drive's frames, as SageICP.iteration_counts()
reads them (counted on the card), over its frames. Layer: the ICP loop
(ops/registration.py::IcpLoop)."""


def read(run):
    if run.traced is None:
        return None
    return float(run.traced.iterations.sum()) / run.traced.frames
