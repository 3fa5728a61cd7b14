"""One module a kind of model, named by a configuration's ``"trainer"``.

A trainer module has ``UNIT`` (what the window counts: ``"tokens"`` or
``"rows"``), ``HOST_OPS`` (host ops whose device time the trace keeps) and
``Cell(cfg, mix, seed, device, workdir, generator)`` with:

- ``setup()``: the store (through ``generator.make_store``), the weights on
  the device from the seed, the port's model, train step and loader
  (entered), as ``loader``;
- ``checked_steps(batches)``: the first steps, read for the reference;
- ``step(batch)``: one step through the port, returning ``(loss, units)``;
- ``mark_window()``, ``close()`` (the loader), ``free()`` (the program's
  state);
- ``work()``: counted work of the window's steps (a dict the metrics read);
- ``check()``: the numbers compared with their limits;
  ``reference(precision, fault)`` and ``data_check()`` for calibration.
"""
