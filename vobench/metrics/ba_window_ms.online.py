"""`WindowedBA.refine_times` (a synchronized wall clock around each
window's refinement: stacking, the captured refiner, the trust gate),
mean over the windows refined in the run."""


def read(r):
    if not r.refine_s:
        return None
    return 1e3 * sum(r.refine_s) / len(r.refine_s)
