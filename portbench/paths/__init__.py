"""Model paths: what the harness needs to know about one model family.

A configuration file names its path under ``"path"`` (``DEFAULT`` where
it names none), and ``manifest.path`` loads ``paths/<path>.py`` by file.  A
path module holds:

- ``program_config(c) -> SpAttenConfig``: the port's configuration for
  the config file ``c``;
- ``make_params(c, seed, device, dtype)``: the weights, made from the
  seed on the device, in the port's layout, handed to the program and
  to the reference alike;
- ``reference``: the plain reference, a module with ``Knobs.from_config``,
  ``Reference(knobs, params, dev, precision=...)``, ``judge`` and
  ``head_mask_from_importance`` (``reference/spatten_ref.py``'s API);
- ``counts``: the model's arithmetic, a module with ``token_flops``,
  ``attention_flops``, ``chunk_context``, ``k1_bytes`` and ``k2_bytes``
  as in ``counts.py`` (the harness hands it to the readers as
  ``obs.counts``).

The card's peaks (``PEAK_*``) and the tail statistic (``percentile``)
are the benchmark's, not a model's: the readers take them from
``portbench/counts.py`` itself, never through a path.

A model family the port runs joins the benchmark with a new path module,
its reference and its counts, as new files.
"""

DEFAULT = "llama"      # the path of a config file that names none
