"""Serving: batched LM decode, continuous batching, accelerator serving.

Layered like a real inference stack (the port of the reference's
``serve`` package):

* ``engine``  — per-call engines: ``DecodeEngine`` (static batch, the
  sequential parity oracle) and ``AcceleratorEngine`` (STT front door as
  a service);
* ``pages``   — paged decode cache (fixed-size pages, slot→page-table
  indirection, shared pool) gathered by the paged-gather kernel, and its
  placement over a mesh by the partition solver;
* ``slots``   — fixed-capacity continuous-batching slot engine over the
  paged cache (insert/evict without draining or rebuilding);
* ``server``  — thread-safe async dispatch loop with per-request futures;
* ``report``  — BENCH_serve.json schema + validator.
"""
from . import engine, pages, report, server, slots
from .engine import AcceleratorEngine, DecodeEngine, ServeConfig
from .pages import PagedKVCache, PageLayout, place_pools, solve_page_placement
from .report import SERVE_SCHEMA_VERSION, serve_entry, validate_serve
from .server import ContinuousServer, Request, RequestFuture
from .slots import ResultTokens, SlotEngine

__all__ = [
    "engine", "pages", "report", "server", "slots",
    "AcceleratorEngine", "DecodeEngine", "ServeConfig",
    "PagedKVCache", "PageLayout", "place_pools", "solve_page_placement",
    "SERVE_SCHEMA_VERSION", "serve_entry", "validate_serve",
    "ContinuousServer", "Request", "RequestFuture",
    "ResultTokens", "SlotEngine",
]
