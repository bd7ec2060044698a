"""A spy for the port's CPU dispatch tests.

A CPU wrapper that hands its call to the plain twin must return the twin's
own result.  Comparing the wrapper's output with a second, separate call of
the twin bit for bit depends on the CPU library's threading (a matmul may
sum in another order when the library picks another thread count), so the
tests record the twin's result with `spy` and check identity instead.
"""


def spy(monkeypatch, module, name):
    """Replace `module.name` by a wrapper that records each call's
    arguments and result; returns the list of (args, kwargs, result)."""
    real = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs, real(*args, **kwargs)))
        return calls[-1][2]

    monkeypatch.setattr(module, name, wrapper)
    return calls
