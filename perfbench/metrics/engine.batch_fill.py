"""Instances solved over the slots of the dispatches the window made:
``EngineStats.solver_calls / (solver_batches * max_batch)``, in %."""


def read(run):
    batches = run.stats["solver_batches"]
    if batches == 0:
        return None
    max_batch = run.cell.config["engine"]["max_batch"]
    return 100.0 * run.stats["solver_calls"] / (batches * max_batch)
