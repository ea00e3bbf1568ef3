"""Window seconds over the CLI jobs completed in it."""


def read(run):
    if run.cell.traffic["kind"] != "cli_job":
        return None
    return run.window_s / len(run.answers)
