"""The views the program's exact engine folded in a traced window: its
counter ``carve_views.views`` read just before and after the window, as
``exact_views`` among the summary's ``counters``.

``attach`` hooks this into ``driver.run`` over ``harness.spans``'s own
hook, without changing either module. The count is added only where the
window folded a view, so a window on another engine, or a program
without the counter, leaves ``counters`` as ``harness.spans`` gives it.
A reader of a metric that needs the count calls ``attach`` when it is
loaded, as ``harness.spans``'s readers call its own.
"""

import contextlib

from . import driver, spans

KEY = "exact_views"


def views():
    """The program's count of views folded by the exact engine, or None
    for a program without it."""
    from vacancy_tpu_torch.ops import fusion

    return getattr(fusion.carve_views, "views", None)


def attach() -> None:
    """Route ``driver.run``'s traced windows through the count as well,
    on top of ``harness.spans.attach``. Idempotent."""
    spans.attach()
    if getattr(driver.summarize, "counts_exact_views", False):
        return
    profiled, summarize = driver._profiled, driver.summarize
    window = {}  # a trace's path -> the views folded in its window

    @contextlib.contextmanager
    def counted(enabled, device):
        before = views()
        with profiled(enabled, device) as exported:
            yield exported
        after = views()
        if exported and before is not None and after > before:
            window[exported[0]] = after - before

    def summarize_with_views(path, window_label, top=10):
        summary = summarize(path, window_label, top)
        folded = window.pop(path, None)
        if folded:
            summary.counters = dict(summary.counters, **{KEY: folded})
        return summary

    summarize_with_views.reads_spans = True
    summarize_with_views.counts_exact_views = True
    driver._profiled, driver.summarize = counted, summarize_with_views
