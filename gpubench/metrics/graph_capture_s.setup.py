"""graph_capture_s.setup: the seconds the program spent capturing its CUDA
graphs in set-up, summed over ``models/step_graph.py::ChunkGraphs.stats``
(``capture_s``; the training chunks' or the evaluation chunks')."""


def read(r):
    v = r.counters.get("graph_capture_s")
    return v if v else None
