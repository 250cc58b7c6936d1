"""The DRA kubelet plugin: NodePrepareResources / NodeUnprepareResources,
CDI specs, the prepared-claim checkpoint and the node's ResourceSlice."""
