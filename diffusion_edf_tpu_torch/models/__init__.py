"""Score model assembly: extractor, keypoints, tensor field, score head."""
