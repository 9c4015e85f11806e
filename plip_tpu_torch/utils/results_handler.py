"""Results CSV appender: a copy of ``plip_tpu.utils.results_handler``, the
reference harness's file contract
(``$PC_RESULTS_FOLDER/extended_results_{task}_{dataset}.csv``, the run's
parameters merged into each record). pandas is imported inside ``add``."""

from __future__ import annotations

import logging
import os
from typing import Dict, List


class ResultsHandler:
    def __init__(self, dataset: str, task: str, storing_params: Dict):
        self.dataset = dataset
        self.task = task
        self.storing_params = storing_params
        logging.info("ResultsHandler created")

    def add(self, results: List[Dict]) -> str:
        import pandas as pd

        for record in results:
            record.update(self.storing_params)

        results_save_folder = os.environ["PC_RESULTS_FOLDER"]
        os.makedirs(results_save_folder, exist_ok=True)
        results_file = os.path.join(
            results_save_folder,
            f"extended_results_{self.task}_{self.dataset}.csv",
        )
        df = pd.DataFrame(results)
        if os.path.exists(results_file):
            all_df = pd.read_csv(results_file, index_col=0)
            all_df = pd.concat([all_df, df], ignore_index=True)
            all_df.to_csv(results_file)
        else:
            df.to_csv(results_file)
        logging.info("ResultsHandler added results")
        return results_file
