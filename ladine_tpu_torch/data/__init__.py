from ladine_tpu_torch.data.synthetic import Gaussians, GaussianMixture1D, add_gaussian_noise

__all__ = ["GaussianMixture1D", "Gaussians", "add_gaussian_noise"]
