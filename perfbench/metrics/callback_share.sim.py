"""% of the window spent in the callbacks the run registered (the wizard, the progress
line, the NaN check, the writer; host clock around each; layer: driver)."""


def read(run, cell):
    spent = sum(sum(t) for t in run.get("callbacks", {}).values())
    return 100.0 * spent / run["window_s"] if spent else None
