"""The kubelet device plugin (see the JAX package's deviceplugin/)."""
