from repro_torch.data.pipeline import DataConfig, DataPipeline, global_batch_at
