"""Sample into Arrow record batches.

Mirror of nuts-rs ``examples/arrow_trace.rs``: one RecordBatch per
chain with list-typed tensor columns (reference ``src/storage/arrow.rs``).
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), _os.pardir))  # repo-root import without install

import nuts_rs_tpu as nt

from _model import make_model, make_settings, print_progress


def main():
    model = make_model()
    settings = make_settings()
    storage = nt.ArrowConfig()

    sampler = nt.Sampler(model, settings, storage=storage,
                         progress_callback=print_progress)
    while not sampler.finished:
        sampler.run_next_chunk()
    tables = sampler.trace.finalize()   # {"posterior": Table, "warmup": Table}
    table = tables["posterior"]

    print("schema:", [f.name for f in table.schema][:6], "...")
    print("rows:", table.num_rows, "(chains x posterior draws)")
    pos = table.column("position").to_pylist()
    print("position[0][:3]:", [round(v, 3) for v in pos[0][:3]])
    assert table.num_rows == settings.num_chains * settings.num_draws
    assert tables["warmup"].num_rows == settings.num_chains * settings.num_tune


if __name__ == "__main__":
    main()
