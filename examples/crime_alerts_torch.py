"""TweetsAboutCrime on the PyTorch port: the paper's spatial channel end to
end.

Users register a location; the channel pushes nearby threatening tweets
(fixed predicates I-III + spatial_distance < 10). Shows the BAD index, the
spatial join on the ``spatial_match`` CUDA kernel (``use_pallas=True``;
its plain version on a CPU engine), and periodic execution with
watermarks. Prints the counts ``examples/crime_alerts.py`` prints on the
same seed.

    PYTHONPATH=src python examples/crime_alerts_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.channel import tweets_about_crime
from repro_torch.core.engine import BADEngine
from repro_torch.core.plans import ExecutionFlags
from repro_torch.data.synthetic import tweet_batch


def main(device: str = "cuda"):
    rng = np.random.default_rng(7)
    eng = BADEngine(dataset_capacity=1 << 15, index_capacity=1 << 14,
                    max_window=1 << 14, max_candidates=1 << 11,
                    use_pallas=True, device=device)
    eng.create_channel(tweets_about_crime(3))

    n_users = 1500
    eng.set_user_locations((rng.normal(size=(n_users, 2)) * 40)
                           .astype(np.float32))
    print(f"{n_users} users registered locations")

    for period in range(3):
        batch = tweet_batch(rng, 8192, t0=1 + period * 600, device=device)
        eng.ingest(batch)
        rep = eng.execute_channel("TweetsAboutCrime3",
                                  ExecutionFlags(scan_mode="bad_index"))
        print(f"period {period}: indexed-candidates={rep.scanned} "
              f"alerts={rep.num_results} wall={rep.wall_time_s*1e3:.1f}ms")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
