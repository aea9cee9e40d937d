"""fluid.faultinject — deterministic fault-injection harness.

The resilience plane (fluid/elastic.py, the PS/RPC retry policy, the
heartbeat miss tolerance) is only trustworthy if its failure paths are
EXERCISED, not just written: a kill mid-save must demonstrably leave a
loadable last-good generation, a delayed RPC must demonstrably hit the
backoff schedule instead of hanging a trainer.  This module is the
chaos hook those tests (and future chaos runs) arm: named sites in the
runtime consult it, and a spec string decides — deterministically, by
hit count — which site fails, how, and on which occurrence.

**Spec.**  ``FLAGS_faultinject`` (env or ``set_flags``) holds
semicolon-separated clauses::

    <site>:<action>[:<arg>][@<n>[+]]

- ``site``   — the instrument point, e.g. ``elastic.shard_write``
- ``action`` — ``die`` (``os._exit(9)``, the kill -9 analog), ``fail``
  (raise ``ConnectionError`` — transport-shaped, so retry machinery
  engages), ``raise`` (raise ``FaultInjected``), ``delay``/``stall``
  (sleep ``arg`` seconds, default 0.05), ``torn`` (returned to the
  caller, which truncates its write), ``drop`` (returned to the
  caller, which skips its send), ``mutate`` (returned to the caller,
  which corrupts an op desc per ``arg`` = progcheck defect kind)
- ``@n``     — fire on the n'th hit of the site only (1-based);
  ``@n+`` fires on the n'th and every later hit; absent = ``@1+``

Examples::

    FLAGS_faultinject='elastic.shard_write:die@2'
    FLAGS_faultinject='rpc.call:delay:0.2@1+;rpc.call:fail@3'
    FLAGS_faultinject='collective.dispatch:stall:0.5@2'

**Determinism.**  Hits are counted per site under a lock; a clause
fires purely on (site, hit index) — no clocks, no randomness — so a
failing chaos run replays exactly.

**Sites.**  The instrumented points of the JAX package (``SITES``, kept
whole so one spec parses alike in both packages).  The port consults
``executor.step``, ``executor.dispatch`` (every step's dispatch, the
eager run or the CUDA-graph replay), ``collective.dispatch`` (each
gradient all-reduce of a data-parallel step) and ``progcheck.mutate``;
the elastic, RPC and heartbeat sites belong to ROADMAP items 16 and 17
of the port, whose modules are not ported yet:

====================== ===============================================
``elastic.shard_write`` per checkpoint shard file, BEFORE the bytes
                        land (``die`` = kill mid-save; ``torn`` =
                        truncated shard, digest mismatch on load)
``elastic.publish``     before a generation's atomic rename
``rpc.call``            per PS RPC attempt, before the frame is sent
                        (``fail``/``delay`` exercise retry/backoff)
``executor.step``       per Executor.run entry (``die`` = worker
                        death mid-run)
``executor.dispatch``   per single-device segment dispatch, consulted
                        only while the hung-step watchdog
                        (``FLAGS_step_timeout_s``) is armed
                        (``stall`` = a hung device call — the
                        watchdog's test vehicle)
``collective.dispatch`` per parallel/collective segment dispatch
                        (``stall`` = a straggling collective)
``heartbeat.send``      per trainer heartbeat ping (``drop`` = a
                        missed heartbeat without killing the sender)
``progcheck.mutate``    per executor plan build (``mutate:<kind>`` =
                        deterministically corrupt one op desc —
                        dangling input, dtype flip, torn sub-block,
                        ... — see ``progcheck.MUTATIONS``; the static
                        verifier must then catch the defect class BY
                        NAME, which ``tools/check_progcheck.py``
                        proves in ``make check``)
====================== ===============================================

Disabled cost: one module-global read per site (``_armed`` is None
when no spec is configured) — the trace/monitor gating discipline.

Observability: ``faultinject/armed`` gauge (clause count),
``faultinject/hits`` (site consultations while armed),
``faultinject/fired`` + ``faultinject/fired/<site>`` (injections that
actually happened), all under the standard registry so the /statusz
elastic section and ``check_stat_coverage`` see them.
"""

import os
import threading
import time

from . import monitor
from .flags import get_flag

__all__ = [
    'FaultInjected', 'SITES', 'configure', 'armed', 'check', 'fired',
    'report', 'reset',
]

SITES = (
    'elastic.shard_write', 'elastic.publish', 'rpc.call',
    'executor.step', 'executor.dispatch', 'collective.dispatch',
    'heartbeat.send', 'progcheck.mutate',
)

_ACTIONS = ('die', 'fail', 'raise', 'delay', 'stall', 'torn', 'drop',
            'mutate')


class FaultInjected(RuntimeError):
    """An injected fault (action ``raise``): distinguishable from real
    failures so a chaos run can tell its own injections apart."""


_lock = threading.Lock()
# None = disarmed (the hot-path fast exit); else {site: [clause, ...]}
_armed = None
_hits = {}
_fired = {}
_spec = ''


def _parse_clause(text):
    """``site:action[:arg][@n[+]]`` -> clause dict, or ValueError."""
    text = text.strip()
    if not text:
        return None
    at = text.rsplit('@', 1)
    nth, plus = 1, True
    if len(at) == 2 and at[1]:
        tail = at[1].strip()
        plus = tail.endswith('+')
        nth = int(tail[:-1] if plus else tail)
        if nth < 1:
            raise ValueError('faultinject: @n must be >= 1 in %r'
                             % text)
        text = at[0]
    parts = text.split(':')
    if len(parts) < 2:
        raise ValueError('faultinject: clause %r needs site:action'
                         % text)
    site, action = parts[0].strip(), parts[1].strip()
    if action not in _ACTIONS:
        raise ValueError('faultinject: unknown action %r (one of %s)'
                         % (action, ', '.join(_ACTIONS)))
    arg = None
    if len(parts) > 2:
        raw = parts[2].strip()
        try:
            arg = float(raw)
        except ValueError:
            # named args: 'progcheck.mutate:mutate:dtype_flip' — the
            # consumer (progcheck.mutate) resolves the name
            arg = raw
    return {'site': site, 'action': action, 'arg': arg,
            'nth': nth, 'plus': plus}


def configure(spec=None):
    """(Re)arm from `spec` (or ``FLAGS_faultinject``).  Empty spec
    disarms.  Hit counters reset — a reconfigure starts a fresh
    deterministic schedule.  Raises ValueError on a malformed spec:
    a typo'd chaos plan must fail loudly, not silently not inject."""
    global _armed, _spec
    if spec is None:
        spec = get_flag('FLAGS_faultinject', '') or ''
    clauses = {}
    for part in str(spec).split(';'):
        c = _parse_clause(part)
        if c is None:
            continue
        clauses.setdefault(c['site'], []).append(c)
    with _lock:
        _spec = str(spec)
        _hits.clear()
        _fired.clear()
        _armed = clauses or None
        monitor.set_gauge('faultinject/armed', float(
            sum(len(v) for v in clauses.values())))
    return _armed is not None


def armed():
    return _armed is not None


def _match(site):
    """Count the hit and return the firing clause (or None).  An
    EXACT '@n' clause takes precedence over an open-ended '@n+' one on
    the same hit — 'rpc.call:delay:0.2@1+;rpc.call:fail@3' delays
    every call except the 3rd, which fails; without the precedence the
    @1+ clause would shadow the one-shot forever."""
    with _lock:
        clauses = (_armed or {}).get(site)
        if not clauses:
            return None
        n = _hits.get(site, 0) + 1
        _hits[site] = n
        chosen = None
        for c in clauses:
            if not c['plus'] and n == c['nth']:
                chosen = c
                break
            if chosen is None and c['plus'] and n >= c['nth']:
                chosen = c
        if chosen is not None:
            _fired[site] = _fired.get(site, 0) + 1
        return chosen


def check(site, **ctx):
    """Consult the harness at `site`.  Executes ``die``/``fail``/
    ``raise``/``delay``/``stall`` itself; returns the clause for the
    caller-handled actions (``torn``, ``drop``) or None.  The hot-path
    contract: callers guard with ``faultinject.armed()`` (one global
    read) so a disarmed process pays nothing."""
    if _armed is None:
        return None
    monitor.add('faultinject/hits')
    c = _match(site)
    if c is None:
        return None
    monitor.add('faultinject/fired')
    monitor.add('faultinject/fired/%s' % site)
    action = c['action']
    if action == 'die':
        # the kill -9 analog: no atexit, no finally blocks, no flush —
        # exactly what crash consistency must survive
        os._exit(9)
    if action == 'fail':
        raise ConnectionError(
            'faultinject: injected transport failure at %s (hit %d)'
            % (site, _hits.get(site, 0)))
    if action == 'raise':
        raise FaultInjected(
            'faultinject: injected fault at %s (hit %d) ctx=%r'
            % (site, _hits.get(site, 0), ctx))
    if action in ('delay', 'stall'):
        time.sleep(c['arg'] if c['arg'] is not None else 0.05)
        return None
    return c   # 'torn'/'drop'/'mutate': the caller implements the damage


def fired(site=None):
    """Injections that actually happened (per site, or total)."""
    with _lock:
        if site is not None:
            return _fired.get(site, 0)
        return sum(_fired.values())


def report():
    """The /statusz ``faultinject`` view: armed spec, per-site hit and
    fire tallies."""
    with _lock:
        return {
            'armed': _armed is not None,
            'spec': _spec,
            'sites': sorted((_armed or {}).keys()),
            'hits': dict(_hits),
            'fired': dict(_fired),
        }


def reset():
    """Disarm and drop counters (tests)."""
    global _armed, _spec
    with _lock:
        _armed = None
        _spec = ''
        _hits.clear()
        _fired.clear()
        monitor.set_gauge('faultinject/armed', 0.0)


# arm from the environment at import: a child process launched with
# FLAGS_faultinject in its env is armed before any instrumented site
# can run (the check tools' kill-mid-save children rely on this)
if (os.environ.get('FLAGS_faultinject') or '').strip():
    configure()
