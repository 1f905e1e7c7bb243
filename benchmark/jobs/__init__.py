"""Job kinds: ``benchmark.jobs.<job>`` defines ``Job(config, workload,
seed, device)`` with ``warm()``, ``run(spans) -> record``, ``release()``
and ``check() -> {number: {"value", "limit"}}``, and
``control_readings(config, seed, device)`` for ``benchmark.control``."""
