"""The program's own spans and counters (raytracer_tpu_torch/utils/profiling)
in a --trace 1 run: the traced requests are the latest recording session,
one root span each. The only module here that reads profiling.recorded().

A program without that recorder, or a session whose root spans are not
one per traced request, gives no reading (None), never a guess."""


def _recorded():
    try:
        from raytracer_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    return recorded()


def spans(run):
    """(the session's spans, its root spans' count), or None without a
    trace, without the recorder, or when the roots are not one per
    traced request."""
    if run.trace is None or not run.traced:
        return None
    recs = _recorded()
    if not recs:
        return None
    roots = sum(1 for r in recs if r.root)
    if roots != len(run.traced):
        return None
    return recs, roots


def _named(recs, name):
    return [r for r in recs if r.name == name and r.end_ns is not None]


def ms_per_root(run, name):
    """Milliseconds of the spans `name` per request."""
    got = spans(run)
    if got is None:
        return None
    recs, roots = got
    return sum(r.duration_ns for r in _named(recs, name)) * 1e-6 / roots


def count_per_root(run, name):
    """Spans `name` per request."""
    got = spans(run)
    if got is None:
        return None
    recs, roots = got
    return len(_named(recs, name)) / roots


def mean_ms(run, name):
    """Mean milliseconds of a span `name`, or None without any."""
    got = spans(run)
    if got is None:
        return None
    named = _named(got[0], name)
    if not named:
        return None
    return sum(r.duration_ns for r in named) * 1e-6 / len(named)


def counter_per_root(run, counter):
    """The counter's increments per request, summed over the spans."""
    got = spans(run)
    if got is None:
        return None
    recs, roots = got
    return sum(r.counts.get(counter, 0) for r in recs) / roots
