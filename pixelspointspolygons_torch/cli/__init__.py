"""The port's commands, each the twin of a JAX script of `scripts/` or
`data_preprocess/`: `python -m pixelspointspolygons_torch.cli.<name> [key.path=value ...] [device=cpu]`."""

__all__ = [
    "all_countries",
    "csv_results_to_latex",
    "dino_v2_ablation",
    "droplidar50_ablation",
    "evaluate",
    "evaluate_gt",
    "gather_pretrained_models",
    "image_res_ablation",
    "lidar_density_ablation",
    "measure_predict_e2e",
    "modality_ablation",
    "postprocess_oracle",
    "prebuild_caches",
    "predict",
    "predict_demo",
    "preprocess_ffl",
    "profile",
    "train",
    "wireframe_loader",
]
